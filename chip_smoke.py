#!/usr/bin/env python3
"""Smoke run of chadavit_tpu_torch on one NVIDIA GPU: the served embedding path,
the DINO train step and the pretrain entry point of ChAdaViT-moyen through the
port's hand-written CUDA kernels, in float32 and in bfloat16 (the canonical
pretrain precision: float32 parameters, bfloat16 activations), then the same
paths of ChAdaViT-B/16 (D 768, 12 heads of 64, FFN 2048) on both of its
routes: the unfused layer, where the attention kernels run at head width 64,
and, where the JAX gate takes the fused layer (1-7 channels in bfloat16, 1-3
in float32), the layer chain's D 768 instances; and the smoke configs' width
(``scripts/smoke/*.yaml``: D 64, 2 heads of 32, FFN 2048), where the JAX gate
always takes the fused layer: the layer chain's D 64 instances and the
attention's head-32 ones, up to the smoke YAML through the port's entry point.
Every kernel has a float32 and a bfloat16 instance (C entry points ``name``
and ``name_bf16``); the attention kernels' head-64 and head-32 instances are
counted as ``name_hd64`` and ``name_hd32``, the layer chain's D 768 and D 64
instances as ``name_d768`` and ``name_d64``.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printed with its elapsed seconds at its start and end:

0. guard: a watchdog ends a hang after WATCHDOG_S with a traceback; no CUDA
   device means exit 1 (there is no CPU path); TF32 off; the card's name and
   power limit from nvidia-smi.
1. build: nvcc compiles csrc/*.cu (layernorm.cu among them), one process per
   source, into one library (cold build seconds); beside it, nvcc -Xptxas -v
   on csrc/linear_fwd_bf16.cu, csrc/linear_bwd_bf16.cu,
   csrc/linear_wgmma_bf16.cu (the wgmma K1a, K1b, K1c, K2b and K2c of
   ChAdaViT-B/16, K1b's LayerNorm row pass and the LN1 pre-pass of K1a and
   K2c),
   csrc/prefix_attention_bf16.cu, csrc/prefix_attention.cu,
   csrc/prefix_attention_bwd.cu, csrc/fused_block.cu, csrc/fused_block_bwd.cu
   and csrc/layernorm.cu prints the registers, shared memory and spills of
   the tensor-core kernels, of the float32 attention forward and of the
   backward's two kernels, of the float32 ln_linear, linear_relu,
   linear_residual_ln and linear_dgrad, of layernorm_bwd's and the float32
   linear_wgrad's two passes and of ln_bwd's four instances at D 192 (the
   model's width), none of which may spill; among them the attention's
   head-64 instances (the float32 forward, prep and backward; the bfloat16
   prep, and its forward, dk/dv and dq on wgmma with TMA,
   attention_fwd_wgmma_kernel, attention_dkdv_wgmma_kernel and
   attention_dq_wgmma_kernel, whose SASS must hold HGMMA and no HMMA) and
   the layer chain's D 768 instances (the float32 K1c among them: the
   128-row GEMM with its ReLU epilogue, gemm128_kernel<2048, 768, 64, 2>;
   the bfloat16 K2a's 16-byte row pass, layernorm_bwd_wide_bf16_kernel),
   none of which may spill; and the head-32 instances and the layer chain's
   D 64 instances (D64_KERNELS), none of which may spill. No kernel may have
   its wgmma products serialized by ptxas (C7510-C7520, whatever the cause:
   a branch around a product, too few registers).
2. each kernel instance against its plain PyTorch version at hub shapes (B 8,
   S_pad 2048, D 192, F 2048, 2 heads, 1..10 channels), float32 on the
   inputs of seed 0, then bfloat16 on those of each of BF16_SEEDS (the worst
   bf16 readings are printed, the bounds are a few times them). The layer
   chain by check_chain: every forward step (ln_linear, linear_relu and
   linear_residual_ln at both sites, with and without their save outputs)
   on the plain chain's intermediates, every call twice for the same bits,
   with zeros on the 32-row tiles past valid_len and counted under its
   instance's name (and how many qkv entries and hid ReLU masks differ from
   the plain versions); the chain's save outputs (LN stats, pre-LN sum)
   against the plain chain's; every backward GEMM and layernorm_bwd call on
   the inputs the layer's backward gives it, twice for the same bits; the
   whole layer forward; the layer's backward through FusedEncoderBlock
   against the plain backward chain on the Function's own residuals (in
   bfloat16 with the kernel's recompute of the FFN hidden, as the
   Function's: backward_reference; and, in float32, against
   torch.autograd.grad of the plain forward with the backward's ReLU mask),
   with a cotangent that is zero past valid_len and one on every row of the
   32-row tiles that hold a valid row. Then the attention: the forward and
   its lse (in float32 zeros and lse 1e30 on the 64-query tiles past
   valid_len), the backward on the layer's inputs twice for the same bits,
   and K4 through PrefixFlashAttention with a cotangent on every row of the
   64-query tiles that hold a valid query. Then the LayerNorm kernels
   (ln_fwd, ln_bwd) against their plain versions on the same rows (B x
   S_pad rows of D 192), with and without the residual, eps 1e-5 and 1e-6,
   and run twice for the same bits (fixed-order sums).
2b. the attention's head-64 instances at ChAdaViT-B/16's hub shapes (B 8,
   S_pad 2048, D 768, 12 heads, the same channels), on q, k and v as the layer
   makes them (column slices of one packed qkv), float32 on seed 0 and
   bfloat16 on each of BF16_SEEDS, at phase 2's bounds: the forward and its
   lse, zeros and lse 1e30 on the 64-query tiles past valid_len, the
   backward with a cotangent on the valid rows and with one on every row of
   the computed tiles, every call twice for the same bits; then K5/K6 at D
   768.
2c. the layer chain's D 768 instances (ChAdaViT-B/16 where the JAX gate
   takes the fused layer) against their plain versions at narrow hub shapes:
   bfloat16 at B 8, S_pad 1408 (channels 1, 3, 5, 7, 2, 7, 4, 6) on each of
   BF16_SEEDS, float32 at S_pad 640 (channels 3, 1, 2, 3, 1, 2, 3, 2): phase
   2's check_chain at D 768 and phase 2's bounds, launches counted under the
   _d768 names (the bfloat16 K1a, K1b, K1c, K2b and K2c there are the wgmma
   kernels of csrc/linear_wgmma_bf16.cu; the GEMM of the first four writes
   the zeros of the 32-row tiles past valid_len itself; the float32 K2c is
   the stream-K walk of csrc/fused_block_bwd.cu). The bfloat16 K1b's out and
   row stats bit for bit the LayerNorm order it keeps
   (tests/torch_bf16_order.py) on its own r, at both sites, on each of
   BF16_SEEDS (check_bf16_d768_ln_order). Then the float32
   K1a, K1c and K1b (128-row GEMMs, K1a and K1b with LayerNorm row passes)
   bit for bit against the summation orders they keep
   (tests/torch_f32_order.py), with and without their save outputs, at the
   float32 narrow and bucket shapes drawn from each of BF16_SEEDS
   (check_f32_d768_bits).
2d. the layer chain's D 64 instances and the attention's head-32 ones (the
   smoke configs' widths: D 64, 2 heads of 32, FFN 2048) against their plain
   versions: phase 2's check_chain at phase 2's bounds, float32 on seed 0
   and bfloat16 on each of BF16_SEEDS, at the hub's channel counts (B 8,
   S_pad 2048, which the JAX gate fuses at D 64) and at the smoke crop (B 16,
   S_pad 128: 32 px crops of 1-4 channels, 5-17 tokens); then K3 and its lse
   and K4 at head 32 on the layer's own q, k, v (column slices of qkv) and on
   the inputs the layer's backward gives K4, each call twice for the same
   bits, with zeros (and lse 1e30) on the 64-query tiles past valid_len.
3. the JAX fixtures: the depth-2, full-width model's CLS embeddings
   (tests/goldens/torch_port_cls_depth2.npz) and three DINO train steps of
   that backbone with the canonical head (tests/goldens/torch_port_dino_depth2.npz),
   then both again in bfloat16 (torch_port_cls_bf16_depth2.npz,
   torch_port_dino_bf16_depth2.npz); then the four ChAdaViT-B/16 fixtures
   (torch_port_{cls,dino}_b16{,_bf16}_depth2.npz: the CLS of images of 10, 7,
   3 and 1 channels, three DINO steps with a 65 536-prototype head on images
   of 10 and 4 channels; every batch pads to 2048 rows, the unfused route),
   and the four narrow B/16 fixtures that JAX computed through its fused
   layer kernel (torch_port_{cls,dino}_b16_narrow{,_bf16}_depth2.npz: the CLS
   of images of 3, 2 and 1 channels, three DINO steps on crops of 3 planes;
   640 rows, the layer chain's D 768 instances).
4. the served path: load_chadavit16_moyen() at depth 12 with seeded weights,
   extract_embeddings on 24 images in batches of 8; the launch count of every
   kernel must be what 12 layers x 3 batches imply, and the embeddings must
   match the same model run through the plain versions on the card. Then the
   same in bfloat16 (load_chadavit16_moyen(dtype=torch.bfloat16)): only the
   bfloat16 instances launch, and the parameters stay float32.
4b. the train path: build_dino(DinoPretrainSpec()) at depth 12 on the card,
   synthetic_dino_batch of 8 images, 3 steps: the loss is finite, the launch
   count of every kernel is what 12 layers x 3 steps x (teacher + student)
   imply, and step 1 agrees with step 1 of a plain backbone
   (fused_encoder_block_reference) from the same state: the loss, and the
   cosine of each tensor's update (zero updates fail, the frozen prototypes
   must stay put); the first layer's backward at the train batch's shapes
   against the plain backward chain. Then the bfloat16 train path at the
   canonical batch (32 images x 2 global crops, depth 12, 3 steps): only the
   bfloat16 instances launch, step 1 agrees with step 1 of the same model
   through the plain chains (FusedEncoderBlock with the plain steps, forward
   and backward) in the same way, and the first layer's backward at these 64
   sequences holds to the bounds of phase 2; the partial-sum scratch of
   linear_wgrad_bf16 and layernorm_bwd at this batch, and of the float32
   linear_wgrad at the float32 train batch and at this one.
4c. the pretrain entry point: main_pretrain.main (the command line) and
   run_dino_pretrain on the canonical YAML
   (scripts/pretrain/dino_chada_vit_moyen.yaml: batch 32, bf16, depth 12)
   with data.dataset=synthetic and backbone.kwargs.ln_impl=pallas, the host
   multicrop loader and checkpoints in a temporary directory. (a) 4 steps
   straight through the command line; (b) 2 steps with a step checkpoint;
   (c) auto-resume from it to
   step 4: the metrics of steps 3-4 and the final train state of (c) equal
   (a)'s bit for bit. The launch count of every kernel in (a) is what 12
   layers x 4 steps x (teacher + student) imply, plus the final norm's
   ln_fwd (teacher and student) and ln_bwd (student). The host loader's time
   per batch beside the step's time, its device span and the time the step
   waited for its batch. Then block_impl=xla in float32 (batch 16): 2 steps,
   every LayerNorm (3 per layer and the final norm) through ln_fwd / ln_bwd,
   and step 1 against the same run with ln_impl=xla (plain LayerNorms): the
   loss, and the per-tensor cosine of the update directions.
4d. on-device augmentation: (a) make_multicrop_fn on the card (a raw uint8
   batch of 32 images, channels 1..10, bench.ASYMMETRIC_AUGS) against the
   same function on the CPU on the same draws, float32 and bfloat16; padded
   planes exactly zero; one seed twice gives the same bits. (b) build_dino
   (bf16, device_augmentations=ASYMMETRIC_AUGS) for 3 steps on raw batches:
   the loss is finite, the launch counts are what 12 layers x 3 steps x
   (teacher + student) imply, and step 1 (on (a)'s draws) agrees with the
   plain build_dino step fed (a)'s crops within 4b's bf16 bounds. (c) the
   entry point on scripts/pretrain/dino_idr10k.yaml (device_augmentations:
   true) over a manifest of 160 images written by the port's generator:
   4 steps straight through the command line, 2 steps with a step
   checkpoint, an auto-resume to step 4 whose metrics of steps 3-4 and final
   state equal the straight run's bit for bit; the decoder used, the
   loader's time per batch, the wait for the batch and each step's device
   span. (d) python -m chadavit_tpu_torch.bench's run at 8 steps with its
   disk phase: its last JSON line parses, its rates are finite and
   positive, 0 < mfu <= 1 and 0 < device_busy_share <= 1; its B/16 phase at
   2 steps, whose fields are finite and positive.
4e. ChAdaViT-B/16: (a) chada_vit(embed_dim=768, num_heads=12) with seeded
   weights through extract_embeddings on 24 images in batches of 8, each
   batch holding a 10-channel image, in float32 and in bfloat16: only the
   head-64 attention forward launches, 12 layers x 3 batches, and the
   embeddings match the same model with the attention's plain version; then
   at max_channels 3 (float32) and 7 (bfloat16), where only the chain's D 768
   forward instances and the head-64 attention forward launch, against the
   same model through the plain versions. (b)
   build_dino at the root bench's B/16 spec (bench.b16_spec), step 1 at
   depth 12 against the same model with the attention's plain forward and
   backward in one autograd Function (one layer's scores at a time): the
   loss and the per-tensor update cosines at 4b's bounds, in float32 at 2
   images x 2 crops and in bfloat16 at 8; and in bfloat16 at 2 images,
   where the DINO loss magnifies bf16 noise past those bounds on both
   sides, the kernels' step and the plain one each against the float32
   plain step, the kernels no farther from it than B16_F32_GAP times the
   plain bf16 step; then 3 steps of 16 raw uint8 images of 10
   channels with the multicrop inside, 24 launches of the head-64 forward
   and 12 of its backward a step; then step 1 on a 7-channel bucket (bfloat16,
   8 images) and a 3-channel bucket (float32, 2 images) through the layer
   chain's D 768 instances, against the same model through the plain chains
   at 4b's bounds (the chain's D 768 launches of the JSON line); in bfloat16,
   where any change of the chain's summation order moves the DINO loss past
   4b's loss bound, the loss against the float32 plain step instead (within
   B16_FUSED_LOSS_F32) and every layer of the step's backbone forward no
   farther from the float32 chain than B16_LAYER_F32_RATIO times the plain
   bf16 chain (layer_gaps). (c)
   main_pretrain on scripts/pretrain/dino_chada_vit_b16_pod.yaml with
   model_parallel=1 fsdp=false devices=1 data.dataset=synthetic and its
   channel buckets as written, 2 steps (batches of 4 and 8 channels, from the
   loader's plan): finite loss, the layer chain's launches at the first and
   the unfused layer's at the second, printed by route.
4f. the smoke YAML through the port's entry point on the card:
   python -m chadavit_tpu_torch.main_pretrain on scripts/smoke/dino_synthetic.yaml
   with tests/torch_port_loop_fixture.py's OVERRIDES, resumed from the JAX
   loop's initial state (the fixture's), 3 steps: its logged metrics against
   the JAX loop's (tests/goldens/torch_port_loop_smoke.npz) within
   SMOKE_METRIC_REL (the host crops, cv2's as the fixture's were); then 3
   steps with precision=bf16 from the port's seeded init: finite losses, and
   step 1 against the same state and batch through the plain chains at 4b's
   bf16 bounds. Both runs print the launches of every _d64 and _hd32
   instance: each above 0, and no other instance launched.
4g. the offline evaluation through the port's entry points, on the
   ChAdaViT-moyen the JAX package pretrained
   (studies/collapse_scale/checkpoints/idr10k_tau994_lrquarter_ep6.npz, D 192,
   depth 12, float32 as the JAX eval path builds it), over a manifest of 160
   train and 64 test images written by the port's generator: (a)
   python -m chadavit_tpu_torch.main_knn's command line on
   scripts/knn/idr100k_synth/dino_idr10k_study.yaml (batch 64, bucket_round
   10: every batch 10 channels wide, S_pad 2048): the CSV's header and one row
   for each (k, T) of the grid, accuracies in [0, 100], only the D 192
   forward instances launched, 12 layers x the batches, the bank's and the
   queries' features against the same model through the plain versions at
   phase 4's SERVED_COS, embeddings/s with the host loader and on the card
   alone. (b) main_linear on scripts/linear/bbbc048/dino_chada_vit_moyen.yaml
   (adamw, batch 32): 4 frozen steps (finite losses, the backbone bit for bit
   the .npz's, the validation suite, the forward's launches), then
   finetune=true layer_decay=0.75 for 2 steps (K2 and K4 12 a step); step 1
   again from one state against the plain chains at 4b's float32 bounds
   (the loss, and the per-tensor cosine of Adam's first moments, zero
   failing); the frozen and finetuned ms a step. (c) main_regression on
   scripts/regression/transloc/dino_chada_vit_moyen.yaml with
   data.dataset=synthetic, 4 steps: finite losses and suite. Each part's
   wall time.
4h. validation during pretraining, main_umap and main_attn, over 4g's
   manifest: (a) python -m chadavit_tpu_torch.main_pretrain on
   scripts/pretrain/dino_idr10k.yaml with VAL_ENTRY (knn_eval on, every
   epoch, the whole train split as the bank, ssl_val_loss, one epoch): 5
   bf16 steps of 32, then one validation through the C++ eval loader
   (NativeEvalLoader, every batch 10 channels wide); the run logs
   val_knn_top1, val_knn_top5 and dino_loss_val, the decoder line names the
   native decoder, the launches are the train steps' chain and the forward of
   every validation batch; from the final checkpoint, the port's offline
   knn_classify over the same loaders gives the logged accuracies, the bank's
   and the queries' features hold to phase 4's bf16 served bound against the
   plain versions, dino_loss_val repeats bit for bit on the same views and
   holds to 4b's bf16 loss bound against the plain chains' eval loss; the C++
   eval loader's embeddings/s beside the host eval loader's over 4g's bank on
   the study checkpoint, and each of its batches within NATIVE_TOL of the host
   path's in file order. (b) main_umap on the study checkpoint over the bank
   (the C++ eval loader): the t-SNE on the card, its seconds and its
   trustworthiness at k 5, the PNG where matplotlib imports, the forward's
   launches. (c) main_attn on one of the manifest's 224 px planes with a
   threshold: every map file, the last layer's attention weights against the
   plain route (every layer through the plain versions) per row at ATTN_COS,
   the launches of the first depth - 1 layers. Which of matplotlib, sklearn
   and umap-learn import.
5. times, entry point by entry point (time_entry), at phase 2's shapes for
   D 192, 2b's for the head-64 attention and 2c's for the D 768 chain
   (chain_runs builds the chain's sites at either width): CUDA events of the
   kernel and its plain version in turns, one PyTorch call for the same
   function (a yardstick the port never calls; where CUDA events read the
   host's launch rate, K2a at every width, K5, K6 and the bf16 K2b and K2c
   at D 64, also by the profiler's device time), its bound (ln_fwd and ln_bwd
   at the final norm's site, over every row: they take no valid_len), and
   the profiler's device time of every kernel of the calls (small calls
   CUDA events time by the host's launch rate) with each kernel's launches
   per round in the trace, each site on its own where an entry point has
   several; the D 768 rows also by CUDA events behind a 0.1 s spin of the
   card (the device's time, free of the host's launch rate), and the layer
   forward at D 768 beside its library layer; linear_wgrad's library call
   is dW and db (at the QKV site of LN1(x)), the product alone printed
   beside it; linear_dgrad's at the ReLU-mask site is the product then the
   mask of hid > 0 (masked_fill_), the product alone printed beside it (both
   also by device time at D 64); ln_bwd also with the L2 cold (a buffer
   larger than the 50 MB L2 written before each call); K3 and K4 run twice
   for the same bits; the whole layer forward and backward; the served
   batch and the train step, in both dtypes; the multicrop's device time per
   step (bf16, B 32) beside the step's; and the B/16 bf16 step of 4e by the
   profiler, on 10 channels and on a 7-channel bucket: the attention
   kernels' and the layer chain's share of its device time against the
   library's GEMMs; the float32 B/16 step 1 on 4e (b)'s 3-channel bucket by
   the profiler, the layer chain's share of its device time; the D 64 and
   head-32 instances at 2d's hub shapes (B 8, S_pad 2048), by CUDA events and
   after a head start.
6. the run's wall time (under WATCHDOG_S), one JSON line with every kernel
   instance, then the last line
   {"ok": true, "device": {...}}. A failed phase prints no last line and
   exits 1.
"""

import contextlib
import dataclasses
import faulthandler
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

WATCHDOG_S = 900
GOLDENS = Path(__file__).resolve().parent / "tests" / "goldens"
FIXTURE = GOLDENS / "torch_port_cls_depth2.npz"
DINO_FIXTURE = GOLDENS / "torch_port_dino_depth2.npz"
FIXTURE_BF16 = GOLDENS / "torch_port_cls_bf16_depth2.npz"
DINO_FIXTURE_BF16 = GOLDENS / "torch_port_dino_bf16_depth2.npz"
CANONICAL = Path(__file__).resolve().parent / "scripts" / "pretrain" / "dino_chada_vit_moyen.yaml"
# ChAdaViT-B/16 (D 768, 12 heads of 64, FFN 2048): its JAX fixtures, the pod YAML
FIXTURE_B16 = GOLDENS / "torch_port_cls_b16_depth2.npz"
DINO_FIXTURE_B16 = GOLDENS / "torch_port_dino_b16_depth2.npz"
FIXTURE_B16_BF16 = GOLDENS / "torch_port_cls_b16_bf16_depth2.npz"
DINO_FIXTURE_B16_BF16 = GOLDENS / "torch_port_dino_b16_bf16_depth2.npz"
B16_YAML = CANONICAL.parent / "dino_chada_vit_b16_pod.yaml"
# ChAdaViT-B/16 where the JAX gate takes the fused layer (3 channels, 640
# rows), computed by JAX through its fused layer kernel: the layer chain's
# D 768 instances on the card
FIXTURE_B16_NARROW = GOLDENS / "torch_port_cls_b16_narrow_depth2.npz"
DINO_FIXTURE_B16_NARROW = GOLDENS / "torch_port_dino_b16_narrow_depth2.npz"
FIXTURE_B16_NARROW_BF16 = GOLDENS / "torch_port_cls_b16_narrow_bf16_depth2.npz"
DINO_FIXTURE_B16_NARROW_BF16 = GOLDENS / "torch_port_dino_b16_narrow_bf16_depth2.npz"

# hub shapes
B, S_PAD, D, H, FFN = 8, 2048, 192, 2, 2048
COUNTS = [1, 3, 5, 10, 2, 7, 9, 10]
N_PATCHES = 196
EPS1, EPS2 = 1e-5, 1e-5
# ChAdaViT-B/16 at the hub shapes above: D 768 in 12 heads of 64; every batch
# pads to S 2048, where the layer takes its unfused route (the attention
# kernels at head width 64 between library products)
D16, H16 = 768, 12

# max abs error against the plain version on rows < valid_len (f32 on both
# sides; the kernels sum in another order than cuBLAS)
KERNEL_TOL = 1e-4
LAYER_TOL = 2e-4
# backward steps: their outputs reach the hundreds (sums over up to 16k rows),
# so the abs tolerance scales with the output's largest entry when that is > 1
GRAD_REL = 1e-4
FIXTURE_COS = 1 - 1e-5  # per-row cosine against the JAX fixture
FIXTURE_TOL = 5e-4      # max abs against the JAX fixture, after 2 layers
SERVED_COS = 1 - 1e-5   # per-row cosine, kernels against plain versions, 12 layers
# the DINO fixture: f32 on both sides through 3 steps of 2 layers, the head and
# LARS. Metrics and parameter norms carry summation order only; the norm of a
# parameter's change is a difference of nearby numbers, so it is looser.
DINO_METRIC_REL = 1e-4
DINO_NORM_REL = 1e-5
DINO_DELTA_REL = 1e-3
# the train path's step 1, kernels against the plain backbone
TRAIN_LOSS_REL = 1e-5
TRAIN_PARAM_COS = 1 - 1e-5
TRAIN_B, TRAIN_STEPS = 8, 3

# bfloat16 kernel instances against their plain bfloat16 versions, which round
# at the same points and sum in other orders: a value can land on the
# neighbouring bf16 and a chain carries such steps. A bf16 output may sit
# BF16_STEPS bf16 steps from the plain one at the reference's largest entry; an
# f32 output (LN stats, lse, parameter gradients: sums of bf16 operands) within
# BF16_F32_REL of its largest entry; the cosine over the rows the kernel
# computes is at least BF16_COS. Each bound is a few times the worst reading of
# phase 2 over BF16_SEEDS on an H100, which phase 2 prints (PERF.md section 6).
BF16_SEEDS = (0, 1, 2)
BF16_STEPS, BF16_F32_REL, BF16_COS = 3, 3e-3, 1 - 2e-5
# the bf16 JAX fixtures: the JAX XLA path rounds at its own points, the
# kernels at the Pallas kernels' (per-row cosine and max abs of the CLS);
# three DINO steps; the bounds of tests/test_torch_fixture_bf16.py, a few
# times the worst reading on the CPU and on the card
FIXTURE_BF16_COS, FIXTURE_BF16_TOL = 1 - 5e-5, 5e-2
DINO_BF16_METRIC_REL, DINO_BF16_NORM_REL, DINO_BF16_DELTA_REL = 5e-3, 1e-3, 5e-2
SERVED_BF16_COS = 1 - 2e-4  # per-row cosine, kernels against plain versions, 12 layers
# the B/16 bf16 CLS fixture: cosine 1 - 1e-4 per row and 4 bf16 steps at the
# CLS's largest entry (tests/test_torch_b16_fixture.py: it reaches past 4)
FIXTURE_B16_BF16_COS, FIXTURE_B16_BF16_STEPS = 1 - 1e-4, 4
# the bf16 train path at the canonical batch (scripts/pretrain/
# dino_chada_vit_moyen.yaml: 32 images, 2 global crops); step 1 against the
# plain chains: the loss, and the cosine of every parameter tensor's update.
# The update bounds are a few times the worst reading on an H100 (PERF.md
# section 6): f32 1 - 1.7e-8, bf16 1 - 7.5e-4 (a wgrad kernel that drops the
# last 64 rows of every sequence reads 1 - 6.5e-3)
TRAIN_BF16_B = 32
TRAIN_BF16_LOSS_REL = 5e-5
TRAIN_UPDATE_COS = 1 - 1e-7       # float32, kernels against the plain backbone
TRAIN_BF16_UPDATE_COS = 1 - 3e-3  # bfloat16, kernels against the plain chains
# the pretrain entry point: the canonical recipe on synthetic data through the
# LayerNorm kernels; (a) straight, (b) stop with a step checkpoint, (c) resume
ENTRY = ["data.dataset=synthetic", "backbone.kwargs.ln_impl=pallas", "log_every=1",
         "checkpoint.enabled=true", "auto_resume.enabled=true"]
ENTRY_STEPS, ENTRY_STOP = 4, 2
# block_impl=xla, float32, LayerNorm kernels against plain LayerNorms: step 1's
# loss and update directions, the bounds of the float32 train path (4b)
ENTRY_XLA = ["precision=f32", "backbone.kwargs.block_impl=xla", "optimizer.batch_size=16",
             "checkpoint.step_frequency=1", "checkpoint.keep_prev=true"]
ENTRY_XLA_STEPS = 2
ENTRY_METRICS = ("dino_loss", "lr", "tau", "teacher_temp", "teacher_entropy",
                 "center_norm", "epoch")
# on-device augmentation: the multicrop of a raw uint8 batch (B 32, channels
# 1..10 as COUNTS, 10 planes) on the card against the same function on the
# CPU on the same draws: float32 within AUG_TOL max abs, bfloat16 within
# phase 2's bf16 bounds (bf16_err). The card's exp and sqrt of the crop box
# may differ from the CPU's by an ulp, and one ulp of a box moves a 224 px
# view of random planes by 2.2e-5 (read on the CPU); the card read 4.0e-5
AUG_B, AUG_TOL = 32, 1e-4
IDR10K = Path(__file__).resolve().parent / "scripts" / "pretrain" / "dino_idr10k.yaml"
# dino_idr10k.yaml on a manifest of IDR_IMAGES images with 7 classes written
# by the port's generator (5 batches of 32): data.sample_ratio=1.0 (its 0.1
# would leave less than a batch), the online kNN off (phase 4h runs it, over
# a manifest with a validation split)
IDR_IMAGES = 160
IDR_ENTRY = ["data.sample_ratio=1.0", "knn_eval.enabled=false", "log_every=1"]
BENCH_STEPS = 8
BENCH_B16_STEPS = 2
# 4e, ChAdaViT-B/16: 24 served images in batches of 8, each batch holding a
# 10-channel image; the train step at the root bench's B/16 spec, step 1
# against the plain attention (float32 at 2 images x 2 crops, bfloat16 at 8
# and, against the float32 step, at 2), then 3 steps of 16 raw
# images of 10 channels with the multicrop; the pod YAML through the entry
# point with the overrides that leave one device, synthetic data and every
# batch padded to 10 channels, 2 steps
B16_SERVED_COUNTS = [10 if i % 8 == 0 else 1 + 3 * i % 9 for i in range(24)]
B16_CHECK_COUNTS = [10, 6]
B16_CHECK_COUNTS_BF16 = [10, 6, 8, 9, 10, 7, 9, 10]
# the bf16 B/16 step 1 at 2 images, each side against the float32 step: the
# kernels' distance within this factor of the plain bf16 step's (the readings
# on an H100 run 0.25-1.15 times it: scripts/b16_bf16_step_gap.py, PERF.md
# section 6)
B16_F32_GAP = 2.0
B16_TRAIN_B = 16
# the narrow widths, where the JAX gate takes the fused layer (the layer
# chain's D 768 instances): served images of 1-3 channels in float32 and 1-7
# in bfloat16 (max_channels 3 and 7); step 1 on a 7-channel bucket of 8
# images in bfloat16 and a 3-channel bucket of 2 in float32
B16_NARROW_SERVED = {"": (3, [1 + i % 3 for i in range(24)]),
                     "_bf16": (7, [1 + 5 * i % 7 for i in range(24)])}
B16_BUCKET_BF16 = (7, [7, 7, 6, 7, 5, 7, 7, 3])
B16_BUCKET_F32 = (3, [3, 2])
# the bf16 step 1 on the fused route. Any change of the bf16 chain's
# summation order moves the DINO loss past 4b's 5e-5: the plain chains with
# each product's even and odd K summed apart read 3.4e-06 to 5.3e-05 from
# the plain chains on five 7-channel batches of 8 and 32 images, the kernels
# 1.5e-06 to 9.4e-05 (scripts/b16_bf16_step_gap.py layers, PERF.md section
# 6). So the kernels' loss is held to the float32 plain step's, where every
# bf16 side of those batches and of the fused mode's six reads at most
# 1.5e-04 (bound twice that), and the forward to the float32 chain layer by
# layer, where the kernels' relative distance reads 0.9980 to 1.0006 times
# the plain bf16 chain's at all 60 layers of those five batches (one rounding
# more or less at one site of a layer moves it by a few per cent). The
# update cosines keep 4b's bound.
B16_FUSED_LOSS_F32 = 3e-4
B16_LAYER_F32_RATIO = 1.01
# the pod YAML with its channel buckets as written (bucket_by_channels: True),
# one device and synthetic data: its first two batches are 4 and 8 channels
# wide, so step 1 takes the layer chain and step 2 the unfused layer
B16_ENTRY = ["model_parallel=1", "fsdp=false", "devices=1", "data.dataset=synthetic",
             "log_every=1"]
B16_ENTRY_STEPS = 2

# 2c, ChAdaViT-B/16 where the JAX gate takes the fused layer: the layer
# chain's D 768 instances at narrow hub shapes, bfloat16 at B 8, S_pad 1408
# (channels up to 7: 6 976 computed rows) on each of BF16_SEEDS, float32 at
# S_pad 640 (up to 3: 3 520 computed rows) on seed 0
NARROW_BF16 = (1408, [1, 3, 5, 7, 2, 7, 4, 6])
NARROW_F32 = (640, [3, 1, 2, 3, 1, 2, 3, 2])
# and at the sequences of 4e (b)'s float32 step (B16_BUCKET_F32's images, two
# crops each, 640 rows: 20 row blocks of 128), where K1b's GEMM takes its
# 64-column tile
BUCKET_F32_SEQ = (640, B16_BUCKET_F32[1] * 2)
# 2d and 4f, the smoke configs' widths (scripts/smoke/*.yaml: D 64, 2 heads of
# 32, FFN 2048; 32 px crops of 16 px patches, 1-4 channels): the hub's channel
# counts (B 8, S_pad 2048) and the smoke crop (B 16, S_pad 128, 4 tokens a
# channel); the entry point on the smoke YAML with the JAX loop fixture's
# overrides, its metrics against that fixture's within SMOKE_METRIC_REL (the
# CPU test's bound, tests/test_torch_loop.py)
D64, H64 = 64, 2
D64_HUB = (S_PAD, [1 + N_PATCHES * c for c in COUNTS])
D64_CROP = (128, [1 + 4 * (1 + i % 4) for i in range(16)])
SMOKE_YAML = CANONICAL.parent.parent / "smoke" / "dino_synthetic.yaml"
SMOKE_METRIC_REL = 1e-5
# 4g, the offline evaluation of a ChAdaViT-moyen the JAX package pretrained
# (the collapse study's epoch-6 backbone, D 192, depth 12, an .npz of JAX
# params) through the port's entry points: the kNN study YAML (batch 64,
# bucket_round 10: every batch 10 channels wide, S_pad 2048), the bbbc048
# linear probe (adamw, batch 32 here, 4 frozen steps and 2 finetuned ones with
# layer decay) and the transloc regression probe on synthetic data (4 steps),
# over a manifest of EVAL_BANK train and EVAL_QUERIES test images written by
# the port's generator (7 classes, 1-10 channels)
ROOT = Path(__file__).resolve().parent
STUDY_NPZ = ROOT / "studies" / "collapse_scale" / "checkpoints" / "idr10k_tau994_lrquarter_ep6.npz"
KNN_YAML = ROOT / "scripts" / "knn" / "idr100k_synth" / "dino_idr10k_study.yaml"
LINEAR_YAML = ROOT / "scripts" / "linear" / "bbbc048" / "dino_chada_vit_moyen.yaml"
REGRESSION_YAML = ROOT / "scripts" / "regression" / "transloc" / "dino_chada_vit_moyen.yaml"
EVAL_BANK, EVAL_QUERIES = 160, 64
PROBE_FROZEN_STEPS, PROBE_FINETUNE_STEPS = 4, 2
# 4h, validation during pretraining: dino_idr10k.yaml over 4g's manifest (its
# EVAL_BANK train images make 5 bf16 steps of 32, its EVAL_QUERIES test images
# the validation split), one epoch, then the online kNN and the SSL validation
# loss through the C++ eval loader; the features held to phase 4's bf16
# served bound, the loss to 4b's bf16 loss bound. Then main_umap over 4g's bank
# and main_attn on one of its 224 px planes, both on the study checkpoint; the
# attention weights against the plain route, per row, in float32. The C++
# eval loader's batches against the host eval loader's within NATIVE_TOL (the
# bound of tests/test_native_loader.py)
VAL_ENTRY = ["data.sample_ratio=1.0", "log_every=1", "knn_eval.enabled=true",
             "knn_eval.frequency=1", "knn_eval.train_sample_ratio=1.0", "ssl_val_loss=true",
             "max_epochs=1"]
VAL_METRICS = ("val_knn_top1", "val_knn_top5", "dino_loss_val")
NATIVE_TOL = 1e-2
ATTN_THRESHOLD, ATTN_COS = 0.6, 1 - 1e-5
# the layer chain's kernels in a profiler trace, by a piece of their names
CHAIN_KERNEL_KEYS = ("ln_linear", "linear_relu", "linear_residual_ln", "layernorm_bwd",
                     "linear_dgrad", "linear_wgrad", "reduce_ln_splits", "reduce_splits",
                     "reduce_wgrad", "ln_rows", "reduce_stream", "linear_wgmma", "gemm128",
                     "res_ln_rows", "reduce_dgrad", "dgrad_list")
CHAIN_ENTRIES = ("ln_linear_fwd", "linear_relu_fwd", "linear_residual_ln_fwd", "layernorm_bwd",
                 "linear_dgrad", "linear_wgrad")

# phase 1: the layer chain's D 768 instances that must be among the kernels
# built (demangled names, without the anonymous namespace)
D768_KERNELS = [
    # bf16 on wgmma (csrc/linear_wgmma_bf16.cu): K1a, K1c, K1b's GEMM at both
    # sites and the four K2b sites (linear_wgmma_kernel<N, K, column tile,
    # epilogue>), K1b's LayerNorm row pass, K2c and its second pass, the LN1
    # pre-pass
    "linear_wgmma_kernel<2304, 768, 256, 3>(", "linear_wgmma_kernel<2048, 768, 256, 4>(",
    "linear_wgmma_kernel<768, 768, 192, 5>(", "linear_wgmma_kernel<768, 2048, 192, 5>(",
    "linear_wgmma_kernel<2048, 768, 256, 1>(", "linear_wgmma_kernel<768, 2048, 192, 2>(",
    "linear_wgmma_kernel<768, 768, 192, 0>(", "linear_wgmma_kernel<768, 2304, 192, 0>(",
    "res_ln_rows_bf16_kernel<768>(",
    "linear_wgrad_wgmma_kernel(", "reduce_stream_kernel(", "ln_rows_kernel<768>(",
    # float32 (fused_block_bwd.cu): K2c's stream-K walk at its two tiles, its
    # second pass and the QKV site's LN1 from the saved stats; K2b's stream-K
    # walk at its three (column tile, epilogue) instances, its second pass
    # and its tile list
    "linear_wgrad_stream_kernel<64, 192>(", "linear_wgrad_stream_kernel<192, 64>(",
    "reduce_wgrad_stream_kernel<64, 192>(", "reduce_wgrad_stream_kernel<192, 64>(",
    "ln_rows_saved_f32_kernel<768>(",
    "linear_dgrad_stream_kernel<256, 1>(", "linear_dgrad_stream_kernel<192, 2>(",
    "linear_dgrad_stream_kernel<192, 0>(", "reduce_dgrad_stream_kernel<256, 1>(",
    "reduce_dgrad_stream_kernel<192, 2>(", "reduce_dgrad_stream_kernel<192, 0>(",
    "dgrad_list_kernel(",
    # float32 (fused_block.cu): K1a's LN1 row pass and GEMM, K1b's GEMM at both
    # sites (the GEMMs in their 96- and 64-column tiles) and its LayerNorm row
    # pass, K1c
    "ln_rows_f32_kernel<768>(", "gemm128_kernel<2304, 768, 96, 0>(",
    "gemm128_kernel<768, 768, 96, 1>(", "gemm128_kernel<768, 2048, 96, 1>(",
    "gemm128_kernel<2304, 768, 64, 0>(", "gemm128_kernel<768, 768, 64, 1>(",
    "gemm128_kernel<768, 2048, 64, 1>(",
    "res_ln_rows_kernel<768>(",
    # K1c: the 128-row GEMM with its ReLU epilogue, in its 64-column tile
    "gemm128_kernel<2048, 768, 64, 2>(",
    # K2a: float32 the D 192 template, bfloat16 the 16-byte row pass (with
    # and without the residual); both take the second pass at D 768
    "layernorm_bwd_kernel<768, float>(", "layernorm_bwd_wide_bf16_kernel<true>(",
    "layernorm_bwd_wide_bf16_kernel<false>(", "reduce_ln_splits_kernel<768>("]
# and its D 64 instances (the smoke configs' width)
D64_KERNELS = [
    # float32 (fused_block.cu, fused_block_bwd.cu): K1a, K1c, K1b at both sites,
    # K2a and its second pass, K2b at the three N 64 sites (its FFN2 site is
    # the D 192 instance), K2c at the four weight shapes
    "ln_linear_kernel<64>(", "linear_relu_kernel<64>(", "linear_residual_ln_kernel<1, 64>(",
    "linear_residual_ln_kernel<2, 64>(", "layernorm_bwd_kernel<64, float>(",
    "layernorm_bwd_kernel<64, __nv_bfloat16>(", "reduce_ln_splits_kernel<64>(",
    "linear_dgrad_kernel<64, 2, 2>(", "linear_dgrad_kernel<64, 0, 2>(",
    "linear_dgrad_kernel<64, 0, 1>(", "linear_wgrad_kernel<192, 64, true>(",
    "linear_wgrad_kernel<64, 64, false>(", "linear_wgrad_kernel<128, 64, false>(",
    "linear_wgrad_kernel<64, 128, false>(",
    # bfloat16 on mma.sync (linear_fwd_bf16.cu, linear_bwd_bf16.cu)
    "ln_linear_bf16_kernel<64>(", "linear_relu_bf16_kernel<64>(",
    "linear_residual_ln_bf16_kernel<64, 64>(", "linear_residual_ln_bf16_kernel<2048, 64>(",
    "linear_dgrad_bf16_kernel<128, 64, 4, 1, true>(",
    "linear_dgrad_bf16_kernel<64, 2048, 1, 2, false>(",
    "linear_dgrad_bf16_kernel<64, 64, 1, 0, false>(",
    "linear_dgrad_bf16_kernel<64, 192, 1, 0, false>(",
    "linear_wgrad_bf16_kernel<64, 64, 4, true>(", "linear_wgrad_bf16_kernel<128, 64, 4, false>(",
    "linear_wgrad_bf16_kernel<64, 128, 2, false>("]

# the card's peaks (NVIDIA H100 SXM data sheet): f32 outside the tensor cores,
# dense bf16 on the tensor cores, and HBM3 bandwidth. The bound of a float32
# instance is taken at the f32 rate, of a bfloat16 instance at the bf16 rate;
# the float32 attention backward at head 64, whose products run on the
# tensor cores in 3xTF32, at the TF32 rate (three products a product).
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 494.7e12  # dense TF32 on the tensor cores, the same data sheet
PEAK_BYTES = 3.35e12

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


class Phase:
    """Prints the start and end of a phase; records a failure."""

    def __init__(self, name: str, failures: list):
        self.name, self.failures = name, failures

    def __enter__(self):
        log(f"phase {self.name}: start")
        return self

    def check(self, ok: bool, what: str) -> None:
        log(f"  {'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            self.failures.append(f"{self.name}: {what}")

    def __exit__(self, *exc):
        log(f"phase {self.name}: end")
        return False


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def valid_rows_err(out, ref, valid_len):
    """(max abs error, max abs error over max |ref|) on the rows < valid_len."""
    err = mag = 0.0
    for i, n in enumerate(valid_len):
        err = max(err, (out[i, :n] - ref[i, :n]).abs().max().item())
        mag = max(mag, ref[i, :n].abs().max().item())
    return err, err / mag


def cosine_rows(a, b):
    import torch

    return torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def plain_backbone(model, x, cc):
    """The model's CLS embeddings with every layer through the plain
    versions of the kernels (fused_encoder_block_reference, plain autograd),
    on x's device."""
    import torch
    import torch.nn.functional as F

    from chadavit_tpu_torch.ops.fused_block import SEQ_PAD, fused_encoder_block_reference

    emb, _ = model.tokenize(x, cc)
    s = emb.shape[1]
    emb = F.pad(emb, (0, 0, 0, -(-s // SEQ_PAD) * SEQ_PAD - s))
    valid_len = (1 + cc.to(torch.int32) * model.num_patches).to(torch.int32)
    for blk in model.blocks:
        emb = fused_encoder_block_reference(emb, valid_len, *blk.weights(), blk.num_heads,
                                            blk.layer_norm_eps, blk.layer_norm_eps)
    return model.final_norm(emb)[:, 0]


def plain_chain_backbone(model, x, cc):
    """The model's CLS embeddings with every layer through the plain chains
    of ops/fused_block.py: under grad FusedEncoderBlock with the plain steps
    (the plain backward chain, no graph of the layer's insides, so the
    reference fits at the canonical train batch), else the plain forward
    chain; on x's device, in the model's compute dtype."""
    import torch
    import torch.nn.functional as F

    from chadavit_tpu_torch.ops import fused_block

    emb, _ = model.tokenize(x, cc)
    s = emb.shape[1]
    emb = F.pad(emb, (0, 0, 0, -(-s // fused_block.SEQ_PAD) * fused_block.SEQ_PAD - s))
    valid_len = (1 + cc.to(torch.int32) * model.num_patches).to(torch.int32)
    for blk in model.blocks:
        eps = blk.layer_norm_eps
        if torch.is_grad_enabled():
            emb = fused_block.FusedEncoderBlock.apply(
                emb, valid_len, blk.num_heads, eps, eps, fused_block.PLAIN_STEPS,
                *blk.weights())
        else:
            emb = fused_block.layer_forward(fused_block.PLAIN_STEPS, emb, valid_len,
                                            blk.weights(), blk.num_heads, eps, eps,
                                            save=False)
    return model.final_norm(emb)[:, 0]


def layer_gaps(spec_bf16, spec_f32, counts, seed=6):
    """Step 1's student backbone on the synthetic batch of ``counts`` (its
    global crops as one pass), layer by layer through the kernels and the
    plain chains in bfloat16 and the plain chains in float32 from the same
    init: each layer's relative L2 distance of the two bf16 outputs from the
    float32 one over the valid rows, ``[(kernels, plain), ...]``."""
    import torch
    import torch.nn.functional as F

    from chadavit_tpu_torch.ops import fused_block
    from chadavit_tpu_torch.train.pretrain import build_dino, synthetic_dino_batch

    def embed(spec):
        _, _, backbone, _ = build_dino(spec)
        batch = synthetic_dino_batch(spec, len(counts), seed=seed, channel_counts=counts)
        crops = batch["crops"]
        cc = batch["channel_counts"].repeat(crops.shape[0])
        with torch.no_grad():
            x, _ = backbone.tokenize(crops.reshape((-1,) + tuple(crops.shape[2:])), cc)
        s = x.shape[1]
        x = F.pad(x, (0, 0, 0, -(-s // fused_block.SEQ_PAD) * fused_block.SEQ_PAD - s))
        return backbone, x, (1 + cc.to(torch.int32) * backbone.num_patches).to(torch.int32)

    model_b, xk, vl = embed(spec_bf16)
    model_f, xf, _ = embed(spec_f32)
    ok = torch.arange(xk.shape[1], device=xk.device)[None, :] < vl[:, None]
    xp, gaps = xk, []
    with torch.no_grad():
        for blk_b, blk_f in zip(model_b.blocks, model_f.blocks):
            eps, heads = blk_b.layer_norm_eps, blk_b.num_heads
            xk, xp, xf = (fused_block.layer_forward(steps, x_, vl, blk.weights(), heads, eps,
                                                    eps, save=False)
                          for steps, x_, blk in ((fused_block.KERNEL_STEPS, xk, blk_b),
                                                 (fused_block.PLAIN_STEPS, xp, blk_b),
                                                 (fused_block.PLAIN_STEPS, xf, blk_f)))
            ref = xf[ok].double()
            gaps.append(tuple(((t[ok].double() - ref).norm() / ref.norm()).item()
                              for t in (xk, xp)))
    del model_b, model_f, xk, xp, xf
    torch.cuda.empty_cache()
    return gaps


def check_updates(ph, what, names, kernel_dirs, plain_dirs, spec, bound, of="the updates"):
    """Step 1's update of every trainable tensor (``names``, in the train
    state's order), the kernels' run against the plain run from the same
    state: a cosine of at least bound per tensor; ``of`` names the buffer
    read in the printed line.
    The update is read from the LARS momentum buffer, which after the first
    step holds the step's direction (the update over -lr) before it meets
    the parameter (an update below half an ulp of a parameter near 1 leaves
    it unchanged). That direction is the gradient's, scaled per tensor, so
    this holds every gradient of the backward. The prototypes frozen in the
    first freeze_last_layer epochs must have a zero update on both sides;
    every other tensor a nonzero one on both (a zero update fails)."""
    import torch

    from chadavit_tpu_torch.train.dino_step import LAST_LAYER

    frozen = LAST_LAYER if spec.freeze_last_layer > 0 else ()
    cosines, still, bad = [], [], []
    for n, dk, dp in zip(names, kernel_dirs, plain_dirs):
        dk, dp = dk.double().flatten(), dp.double().flatten()
        if n in frozen:
            (bad if dk.any() or dp.any() else still).append(n)
        elif not (dk.any() and dp.any()):
            bad.append(n)
        else:
            cosines.append((torch.nn.functional.cosine_similarity(dk, dp, 0).item(), n))
    cosines.sort()
    ph.check(not bad and bool(cosines) and cosines[0][0] >= bound,
             f"{what}, per-tensor cosine of {of}, kernels against plain, "
             f"{len(cosines)} tensors: worst "
             + ", ".join(f"1 - {1 - c:.2e} ({n})" for c, n in cosines[:4])
             + f"; median 1 - {1 - cosines[len(cosines) // 2][0]:.2e} (>= 1 - {1 - bound:.0e}); "
             f"frozen, zero on both sides: {still}; zero update, or frozen and moved: {bad}")


def backward_reference(dy, x, valid_len, res, w, heads, eps):
    """The plain backward chain that FusedEncoderBlock's backward is held
    against, on the residuals ``res`` its own forward saved. In bfloat16 the
    chain's recompute of the FFN hidden is the kernel's, as the Function's
    is: the tensor-core linear_relu sums in another order than the plain
    version (which equals the CUDA-core kernel bit for bit), and a
    pre-activation that the two round to opposite sides of 0 flips a ReLU
    mask and moves a whole gradient row, the kink of ReLU and not a fault of
    a backward kernel. The forward kernels are held to their plain versions
    on their own in phase 2, which counts such flips."""
    import torch
    from types import SimpleNamespace

    from chadavit_tpu_torch.ops import fused_block

    steps = fused_block.PLAIN_STEPS
    if dy.dtype != torch.float32:
        steps = SimpleNamespace(**{**vars(steps), "linear_relu": fused_block.linear_relu})
    return fused_block.layer_backward(steps, dy, x, valid_len, *res, w, heads, eps)


def check_layer_backward(ph, backbone, batch, dt, seed=5):
    """The first encoder layer's backward at the train path's shapes (the
    batch's global crops as one pass, tokenized by backbone), with a seeded
    cotangent on every row the forward computes: FusedEncoderBlock on the card
    against the plain backward chain on the residuals its own forward saves,
    within the bounds of phase 2."""
    import torch
    import torch.nn.functional as F

    from chadavit_tpu_torch.ops import fused_block

    crops, cc = batch["crops"], batch["channel_counts"]
    cc = cc.repeat(crops.shape[0])
    with torch.no_grad():
        x, _ = backbone.tokenize(crops.reshape((-1,) + tuple(crops.shape[2:])), cc)
        s = x.shape[1]
        x = F.pad(x.to(dt), (0, 0, 0, -(-s // fused_block.SEQ_PAD) * fused_block.SEQ_PAD - s))
    valid = (1 + cc.to(torch.int32) * backbone.num_patches).to(torch.int32)
    rows = [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in valid.tolist()]
    blk = backbone.blocks[0]
    w = [t.detach() for t in blk.weights()]
    heads, eps = blk.num_heads, blk.layer_norm_eps
    gen = torch.Generator(device=x.device).manual_seed(seed)
    dy = torch.randn(x.shape, generator=gen, device=x.device)
    for i, n in enumerate(rows):
        dy[i, n:] = 0
    dy = dy.to(dt)
    xg = x.clone().requires_grad_(True)
    wg = [t.clone().requires_grad_(True) for t in w]
    grads = torch.autograd.grad(fused_block.fused_encoder_block(xg, valid, *wg, heads, eps, eps),
                                [xg, *wg], dy)
    with torch.no_grad():
        _, res = fused_block.layer_forward(fused_block.KERNEL_STEPS, x, valid, tuple(w), heads,
                                           eps, eps, save=True)
        same = backward_reference(dy, x, valid, res, w, heads, eps)
    torch.cuda.synchronize()
    pairs = [(gk, gr.reshape(gk.shape)) for gk, gr in zip(grads[1:], same[1:])]
    if dt == torch.float32:
        err = valid_rows_err(grads[0], same[0], rows)[0]
        worst = max((gk - gr).abs().max().item() / gr.abs().max().item() for gk, gr in pairs)
        ok = err <= KERNEL_TOL * max(1.0, same[0].abs().max().item()) and worst <= GRAD_REL
        what = f"dx max abs {err:.3e}, 12 grads worst max abs over max |ref| {worst:.3e}"
    else:
        checks = [bf16_err(grads[0], same[0], rows)] + [bf16_err(gk, gr) for gk, gr in pairs]
        ok = all(e <= t and c >= BF16_COS for e, t, c in checks)
        what = (f"dx and 12 grads, worst max abs over its bound "
                f"{max(e / t for e, t, _ in checks):.3f}, worst cosine "
                f"1 - {1 - min(c for _, _, c in checks):.2e}")
    tail_zero = all(not grads[0][i, n:].any().item() for i, n in enumerate(rows))
    ph.check(ok and tail_zero,
             f"{'bf16 ' if dt != torch.float32 else ''}layer backward at the train path's "
             f"shapes ({x.shape[0]} sequences of {x.shape[1]}, valid_len {min(valid.tolist())}"
             f"..{max(valid.tolist())}), FusedEncoderBlock against the plain backward chain: "
             f"{what}; dx zero on the zero-filled tiles: {tail_zero}")


class Bf16Notes:
    """The bfloat16 readings of a phase: an instance's output against its
    plain version within bf16_err's bounds, its max abs error kept in
    ``stats[name]`` (when name is an instance), and the worst readings (bf16
    steps of a bf16 output, share of the largest entry of an f32 one,
    1 - cosine), of which the bounds are a few times; ``where`` (the seed)
    is added to each reading's label."""

    def __init__(self, ph, stats):
        self.ph, self.stats, self.where = ph, stats, ""
        self.worst = {"steps": (0.0, ""), "f32": (0.0, ""), "1 - cos": (0.0, "")}

    def measure(self, out, ref, rows=None, what=""):
        """(max abs error, its bound, cosine), kept among the worst readings."""
        import torch

        torch.cuda.synchronize()
        err, tol, cos = bf16_err(out, ref, rows)
        key, unit = (("steps", BF16_STEPS) if out.dtype == torch.bfloat16
                     else ("f32", BF16_F32_REL))
        for k, v in ((key, err * unit / tol if tol else 0.0), ("1 - cos", 1 - cos)):
            if v > self.worst[k][0]:
                self.worst[k] = (v, what + self.where)
        return err, tol, cos

    def note(self, name, out, ref, what, rows=None):
        """The reading, checked against its bounds."""
        err, tol, cos = self.measure(out, ref, rows, name + what)
        if name in self.stats:
            self.stats[name]["max_abs_err"] = max(self.stats[name]["max_abs_err"], err)
        self.ph.check(err <= tol and cos >= BF16_COS,
                      f"{name}{what}: max abs {err:.3e} (tolerance {tol:.3g}), cosine "
                      f"1 - {1 - cos:.2e} (>= 1 - {1 - BF16_COS:.0e})")

    def summary(self):
        return ("; ".join(f"{k} {v:.3g} ({where})" for k, (v, where) in self.worst.items())
                + f" (bounds {BF16_STEPS} steps, {BF16_F32_REL:g}, {1 - BF16_COS:.0e})")


def draw_layer(rng, dev, bsz, s_pad, d, f, valid_len):
    """A layer's input x, its 12 float32 parameters and two cotangents from
    the numpy generator ``rng``: dy on the valid rows, dy_tail on every row
    of the 32-row tiles that hold a valid row."""
    import numpy as np
    import torch

    from chadavit_tpu_torch.ops import fused_block

    def dev_randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    x = dev_randn(bsz, s_pad, d)
    w = [dev_randn(3 * d, d, scale=d ** -0.5), dev_randn(3 * d, scale=0.02),
         dev_randn(d, d, scale=d ** -0.5), dev_randn(d, scale=0.02),
         1 + dev_randn(d, scale=0.1), dev_randn(d, scale=0.05),
         1 + dev_randn(d, scale=0.1), dev_randn(d, scale=0.05),
         dev_randn(f, d, scale=d ** -0.5), dev_randn(f, scale=0.02),
         dev_randn(d, f, scale=f ** -0.5), dev_randn(d, scale=0.02)]
    dy, dy_tail = dev_randn(bsz, s_pad, d), dev_randn(bsz, s_pad, d)
    for i, n in enumerate(valid_len):
        dy[i, n:] = 0
        dy_tail[i, -(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK:] = 0
    return x, w, dy, dy_tail


def check_chain(ph, stats, note_bf16, x, w, dy, dy_tail, valid_len, heads, what_shape):
    """The layer chain's instances at x's width and dtype against their plain
    versions (phases 2 and 2c): the forward steps with and without their
    save outputs (both K1b sites) on the plain chain's intermediates, each
    call twice for the same bits, with zeros on the 32-row tiles past
    valid_len and counted under the width's instance names; the chain's
    save outputs against the plain chain's; every backward step except the
    attention's on the inputs the plain backward chain gives it, twice for
    the same bits; the layer forward, and its backward through
    FusedEncoderBlock against the plain backward chain on the Function's own
    residuals (backward_reference; in float32 also against autograd of the
    plain forward with the backward's ReLU mask), with the cotangent dy on
    the valid rows and dy_tail on every row of the computed tiles. The hid
    ReLU masks that flip against the plain versions are counted. Float32
    outputs are held within KERNEL_TOL (GRAD_REL of the largest entry for
    the backward's), bfloat16 ones by ``note_bf16(name, out, ref, what,
    rows)``. Returns the inputs, the plain chain's intermediates and
    residuals and the backward steps' recorded calls (the attention's
    among them), for the phase's attention checks and phase 5."""
    import torch
    from types import SimpleNamespace

    from chadavit_tpu_torch.ops import _launch, fused_block
    from chadavit_tpu_torch.ops import flash_attention as fa

    bsz, _, d = x.shape
    dt, h, f = x.dtype, heads, w[8].shape[0]
    f32 = dt == torch.float32
    rows = [-(-n // fused_block.ROW_BLOCK) * fused_block.ROW_BLOCK for n in valid_len]
    vl = torch.tensor(valid_len, dtype=torch.int32, device=x.device)
    tag = "" if f32 else "_bf16"

    def name_of(entry):
        return fused_block.instance(entry + tag, d)

    def note(name, out, ref, what, rows_=valid_len, tol=KERNEL_TOL):
        torch.cuda.synchronize()
        if not f32:
            note_bf16(name, out, ref, what, rows_)
            return
        if out.dim() == 3:
            err = valid_rows_err(out, ref, rows_)[0]
        else:
            err = (out - ref).abs().max().item()
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        ph.check(err <= tol, f"{name}{what}: max abs {err:.3e} (tolerance {tol:.3g})")

    wd = fused_block.pack_weights(tuple(w), dt)
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = wd
    qkv = fused_block.ln_linear_reference(x, g1, b1, EPS1, wqkv, bqkv)
    attn = fa.prefix_flash_attention_reference(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                                               vl, h)
    x2 = fused_block.linear_residual_ln_reference(attn, wout, bout, x, g1, b1, EPS1)
    hid = fused_block.linear_relu_reference(x2, w1, b1f)

    # the forward steps: each twice, the same bits, zeros past the computed tiles
    cases = [("ln_linear_fwd", "", False,
              lambda: fused_block.ln_linear(x, g1, b1, EPS1, wqkv, bqkv, vl), lambda: qkv),
             ("ln_linear_fwd", " save", True,
              lambda: fused_block.ln_linear(x, g1, b1, EPS1, wqkv, bqkv, vl, save=True),
              lambda: fused_block.ln_linear_reference(x, g1, b1, EPS1, wqkv, bqkv, save=True)),
             ("linear_relu_fwd", "", False, lambda: fused_block.linear_relu(x2, w1, b1f, vl),
              lambda: hid)]
    for site, args, eps in ((" out projection", (attn, wout, bout, x, g1, b1), EPS1),
                            (" FFN2", (hid, w2, b2f, x2, g2, b2), EPS2)):
        for save in (False, True):
            cases.append(("linear_residual_ln_fwd", site + " save" * save, save,
                          (lambda a=args, e=eps, sv=save: fused_block.linear_residual_ln(
                              *a, e, vl, save=sv)),
                          (lambda a=args, e=eps, sv=save:
                           fused_block.linear_residual_ln_reference(*a, e, save=sv))))
    for entry, what, save, kernel_fn, plain_fn in cases:
        name = name_of(entry)
        before = _launch.LAUNCHES[name]
        first, again = kernel_fn(), kernel_fn()
        torch.cuda.synchronize()
        firsts = first if save else (first,)
        agains = again if save else (again,)
        ph.check(_launch.LAUNCHES[name] == before + 2 and firsts[0].dtype == dt
                 and all(torch.equal(a_, b_) for a_, b_ in zip(firsts, agains))
                 and all(not o[i, n:].any().item() for o in firsts for i, n in enumerate(rows)),
                 f"{name}{what}{what_shape}: counted as {name}, writes {dt}, the same bits on a "
                 f"second call, zeros on the 32-row tiles past valid_len")
        refs = plain_fn()
        refs = refs if save else (refs,)
        for o, r, part in zip(firsts, refs, ("", " mean", " rstd", " r")):
            if o.dim() == 2:  # the row stats
                o, r = o[..., None], r[..., None]
            note(name, o, r, what + part)
        del first, again, firsts, agains, refs
    if not f32:
        qk = fused_block.ln_linear(x, g1, b1, EPS1, wqkv, bqkv, vl)
        differ = sum(int((qk[i, :n] != qkv[i, :n]).sum()) for i, n in enumerate(rows))
        log(f"  {name_of('ln_linear_fwd')}{what_shape}: {differ} entries of qkv differ from the "
            f"plain version, in {sum(rows) * 3 * d} entries")
        del qk

    # the chain's save outputs against the plain chain's: the LN1 stats, the
    # site-2 norm1's and LN2's (mean and rstd of a site as one tensor), r2
    _, (ra, rx2, rr2, rlse, rst) = fused_block.layer_forward(
        fused_block.PLAIN_STEPS, x, vl, tuple(w), h, EPS1, EPS2, save=True)
    _, (ka, kx2, kr2, klse, kst) = fused_block.layer_forward(
        fused_block.KERNEL_STEPS, x, vl, tuple(w), h, EPS1, EPS2, save=True)
    torch.cuda.synchronize()
    ph.check(all(t.dtype == torch.float32 for t in (*kst, klse))
             and all(t.dtype == dt for t in (ka, kx2, kr2)),
             f"save outputs{what_shape}: activations {dt}, stats and lse float32")
    note(name_of("ln_linear_fwd"), torch.stack(kst[:2], -1), torch.stack(rst[:2], -1),
         " save outputs mean, rstd")
    note(name_of("linear_residual_ln_fwd"), torch.stack(kst[2:], -1), torch.stack(rst[2:], -1),
         " save outputs mean, rstd")
    note(name_of("linear_residual_ln_fwd"), kr2, rr2, " save output r2")
    # the FFN hidden of the kernels' forward chain against the plain chain's:
    # entries whose ReLU mask the two sums put on opposite sides of 0 (each
    # moves a whole row of dz1, the kink of ReLU, not a fault of a kernel)
    hk = fused_block.linear_relu(kx2, w1, b1f, vl)
    hp = fused_block.linear_relu_reference(kx2, w1, b1f)
    chain_flips = sum(int(((hk[i, :n] > 0) != (hid[i, :n] > 0)).sum())
                      for i, n in enumerate(rows))
    flips = sum(int(((hk[i, :n] > 0) != (hp[i, :n] > 0)).sum()) for i, n in enumerate(rows))
    differ = sum(int((hk[i, :n] != hp[i, :n]).sum()) for i, n in enumerate(rows))
    log(f"  {name_of('linear_relu_fwd')} on the layer's own x2{what_shape}: {differ} entries "
        f"differ from the plain version, {flips} of them ReLU mask flips, in "
        f"{sum(rows) * f} entries; against the plain forward chain's hid, {chain_flips} "
        f"mask flips")
    del hk, hp

    # every backward step on the inputs the plain backward chain gives it
    rec = Recorder(fused_block.PLAIN_STEPS)
    fused_block.layer_backward(rec, dy, x, vl, ra, rx2, rr2, rlse, rst, w, h, EPS1)
    kernel_step = {"layernorm_bwd": fused_block.layernorm_bwd,
                   "linear_dgrad": fused_block.linear_dgrad,
                   "linear_wgrad": fused_block.linear_wgrad}
    bwd_inputs = {name: [] for name in (*kernel_step, "attention_bwd")}
    for entry, (args, kwargs), ref_out in rec.calls:
        if entry in bwd_inputs:
            bwd_inputs[entry].append((args, kwargs))
        if entry not in kernel_step:
            continue
        name = name_of(entry)
        before = _launch.LAUNCHES[name]
        outs, agains = ((o if isinstance(o, tuple) else (o,)) for o in (
            kernel_step[entry](*args, **{k: (v.clone() if k == "dgb" else v)
                                         for k, v in kwargs.items()}) for _ in range(2)))
        torch.cuda.synchronize()
        shape = tuple(outs[0].shape)
        ph.check(_launch.LAUNCHES[name] == before + 2
                 and all(torch.equal(a_, b_) for a_, b_ in zip(outs, agains))
                 and all(o.dtype == (dt if o.dim() == 3 else torch.float32) for o in outs)
                 and all(not o[i, n:].any().item() for o in outs if o.dim() == 3
                         for i, n in enumerate(valid_len)),
                 f"{name} ({shape}){what_shape}: counted, activations {dt} and parameter "
                 f"gradients float32, the same bits on a second call, zeros past valid_len")
        for o, r in zip(outs, ref_out if isinstance(ref_out, tuple) else (ref_out,)):
            if f32:
                mag = (max(r[i, :n].abs().max().item() for i, n in enumerate(valid_len))
                       if o.dim() == 3 else r.abs().max().item())
                note(name, o, r, f" ({tuple(o.shape)}, output scale {mag:.3g})",
                     tol=GRAD_REL * max(1.0, mag))
            else:
                note(name, o, r, f" ({tuple(o.shape)})", valid_len if o.dim() == 3 else None)
        del outs, agains

    # the layer: forward, and its backward through FusedEncoderBlock
    layer = fused_block.fused_encoder_block(x, vl, *w, h, EPS1, EPS2)
    layer_ref = fused_block.fused_encoder_block_reference(x, vl, *w, h, EPS1, EPS2)
    if f32:
        err, rel = valid_rows_err(layer, layer_ref, valid_len)
        ph.check(err <= LAYER_TOL, f"fused_encoder_block at D {d}{what_shape}: max abs "
                                   f"{err:.3e}, max rel {rel:.3e} (tolerance {LAYER_TOL:g})")
    else:
        note_bf16("layer", layer, layer_ref, f" fused_encoder_block at D {d}", valid_len)
    names = ["wqkv", "bqkv", "wout", "bout", "g1", "b1", "g2", "b2", "w1", "b1f", "w2", "b2f"]
    attn_bwd = fa.instance(_launch.entry_point("prefix_attention_bwd", dt), d // h)
    for what, dy_, rows_ in ((" cotangent on the valid rows", dy, valid_len),
                             (" tail cotangent (every row of the computed tiles)", dy_tail,
                              rows)):
        xg = x.clone().requires_grad_(True)
        wg = [t.clone().requires_grad_(True) for t in w]
        counted = {"layernorm_bwd": name_of("layernorm_bwd"),
                   "linear_dgrad": name_of("linear_dgrad"),
                   "linear_wgrad": name_of("linear_wgrad"), "attention_bwd": attn_bwd}
        before = {n: _launch.LAUNCHES[c] for n, c in counted.items()}
        y = fused_block.fused_encoder_block(xg, vl, *wg, h, EPS1, EPS2)
        grads = torch.autograd.grad(y, [xg, *wg], dy_)
        torch.cuda.synchronize()
        launched = {n: _launch.LAUNCHES[c] - before[n] for n, c in counted.items()}
        same = backward_reference(dy_, x, vl, (ka, kx2, kr2, klse, kst), w, h, EPS1)
        # dx is zero past the rows the cotangent reaches: past valid_len with
        # dy, on the zero-filled tiles with dy_tail
        tail_zero = all(not grads[0][i, n:].any().item() for i, n in enumerate(rows_))
        ph.check(type(y.grad_fn).__name__ == "FusedEncoderBlockBackward" and tail_zero
                 and launched == {"layernorm_bwd": 3, "linear_dgrad": 4, "linear_wgrad": 4,
                                  "attention_bwd": 1}
                 and grads[0].dtype == dt and all(g.dtype == torch.float32 for g in grads[1:]),
                 f"layer backward at D {d}{what}{what_shape}: the Function, launches "
                 f"{launched}, dx {grads[0].dtype} and zero past the rows of the cotangent")
        if f32:
            err = valid_rows_err(grads[0], same[0], rows_)[0]
            worst = max(((gk - gr.reshape(gk.shape)).abs().max().item() / gr.abs().max().item(), n)
                        for n, gk, gr in zip(names, grads[1:], same[1:]))
            ph.check(err <= KERNEL_TOL * max(1.0, same[0].abs().max().item())
                     and worst[0] <= GRAD_REL,
                     f"layer backward at D {d}{what}, against the plain backward chain on the "
                     f"Function's own residuals: dx max abs {err:.3e}, 12 grads worst max abs "
                     f"over max |ref| {worst[0]:.3e} ({worst[1]})")
            if dy_ is dy:  # and against autograd of the plain forward
                # with its ReLU mask pinned to the one the Function's backward
                # recomputes (the kernel's hid of the chain's own x2): an FFN
                # pre-activation that the two forward chains sum to opposite
                # sides of 0 flips a mask and moves a whole gradient row (the
                # kink of ReLU, counted above), and both masks are gradients of
                # the layer there
                mask = fused_block.linear_relu(kx2, w1, b1f, vl) > 0
                pinned = SimpleNamespace(**{**vars(fused_block.PLAIN_STEPS), "linear_relu": (
                    lambda a_, w_, b_, v_=None: torch.where(mask, torch.matmul(a_, w_.t()) + b_,
                                                            0.0))})
                y_ref = fused_block.layer_forward(pinned, xg, vl, tuple(wg), h, EPS1, EPS2,
                                                  save=False)
                grads_ref = torch.autograd.grad(y_ref, [xg, *wg], dy_)
                err = valid_rows_err(grads[0], grads_ref[0], valid_len)[0]
                worst = max(((gk - gr).abs().max().item() / gr.abs().max().item(), n)
                            for n, gk, gr in zip(names, grads[1:], grads_ref[1:]))
                ph.check(err <= KERNEL_TOL * max(1.0, grads_ref[0].abs().max().item())
                         and worst[0] <= GRAD_REL,
                         f"layer backward at D {d}, against autograd of the plain forward with "
                         f"the backward's ReLU mask ({chain_flips} entries flip against the "
                         f"plain forward's): dx max abs {err:.3e}, 12 grads worst max abs over "
                         f"max |ref| {worst[0]:.3e} ({worst[1]})")
                del y_ref, grads_ref, mask
        else:
            note_bf16("layer backward", grads[0], same[0], f" dx at D {d}{what}", rows_)
            for n, gk, gr in zip(names, grads[1:], same[1:]):
                note_bf16("layer backward", gk, gr.reshape(gk.shape), f" {n} at D {d}{what}",
                          None)
        del xg, wg, y, grads, same
    out = dict(x=x, w=w, wd=wd, qkv=qkv, attn=attn, x2=x2, hid=hid, dy=dy, vl=vl,
               valid_len=valid_len, bwd_inputs=bwd_inputs, ra=ra, rx2=rx2, rr2=rr2, rlse=rlse,
               rst=rst, klse=klse)
    del ka, kx2, kr2, kst, layer, layer_ref, rec
    return out


def check_f32_d768_bits(ph, x, w, valid_len, heads, what_shape):
    """The float32 K1a, K1c and K1b at D 768 against the summation orders they
    keep (tests/torch_f32_order.py: the first port's K1a and K1c, the
    four-block column cluster's K1b), bit for bit, with and without their save
    outputs: K1a on x, K1b at the out-projection on the attention output of
    the model's qkv, K1c on the model's x2 and K1b at FFN2 on K1c's hid (the
    plain attention between them). Zeros on the tiles past valid_len are part
    of the models."""
    import torch

    from chadavit_tpu_torch.ops import fused_block
    from chadavit_tpu_torch.ops import flash_attention as fa
    from tests import torch_f32_order as order

    d = x.shape[-1]
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = w
    vl = torch.tensor(valid_len, dtype=torch.int32, device=x.device)
    with torch.no_grad():
        k1a = order.ln_linear_order(x, g1, b1, EPS1, wqkv, bqkv, valid_len)
        qkv = k1a[0]
        attn = fa.prefix_flash_attention_reference(qkv[..., :d], qkv[..., d:2 * d],
                                                   qkv[..., 2 * d:], vl, heads)
        k1b_out = order.linear_residual_ln_order(attn, wout, bout, x, g1, b1, EPS1, valid_len)
        hid = order.linear_relu_order(k1b_out[0], w1, b1f, valid_len)
        k1b_ffn2 = order.linear_residual_ln_order(hid, w2, b2f, k1b_out[0], g2, b2, EPS2,
                                                  valid_len)
        cases = [("ln_linear_fwd", "", lambda sv: fused_block.ln_linear(
            x, g1, b1, EPS1, wqkv, bqkv, vl, save=sv), k1a),
                 ("linear_relu_fwd", "", lambda sv: (fused_block.linear_relu(
                     k1b_out[0], w1, b1f, vl),), (hid,))]
        for site, args, eps, ref in ((" out projection", (attn, wout, bout, x, g1, b1), EPS1,
                                      k1b_out),
                                     (" FFN2", (hid, w2, b2f, k1b_out[0], g2, b2), EPS2,
                                      k1b_ffn2)):
            cases.append(("linear_residual_ln_fwd", site, (
                lambda sv, a=args, e=eps: fused_block.linear_residual_ln(*a, e, vl, save=sv)),
                ref))
        for entry, site, fn, ref in cases:
            for save in (False, True) if entry != "linear_relu_fwd" else (False,):
                got = fn(save)
                got = got if save or entry == "linear_relu_fwd" else (got,)
                torch.cuda.synchronize()
                same = [torch.equal(o, r) for o, r in zip(got, ref)]
                worst = max((o - r).abs().max().item() for o, r in zip(got, ref))
                ph.check(all(same), f"{fused_block.instance(entry, d)}{site}{' save' * save}"
                                    f"{what_shape}: the bits of its order model "
                                    f"(tests/torch_f32_order.py), outputs equal {same}, max abs "
                                    f"{worst:.3e}")
                del got


def check_bf16_d768_ln_order(ph, inp, what_shape):
    """The bfloat16 K1b at D 768 (a wgmma GEMM writes r, a row pass takes the
    LayerNorm): out and the row stats bit for bit the LayerNorm order of the
    four-block column cluster it replaces (tests/torch_bf16_order.py) applied
    to the kernel's own r, at both sites, on check_chain's inputs ``inp``
    (the out-projection on the plain chain's attention output, FFN2 on its
    FFN hidden)."""
    import torch

    from chadavit_tpu_torch.ops import fused_block
    from tests import torch_bf16_order as order

    d = inp["x"].shape[-1]
    wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = inp["wd"]
    for site, args, eps in ((" out projection", (inp["attn"], wout, bout, inp["x"], g1, b1),
                             EPS1),
                            (" FFN2", (inp["hid"], w2, b2f, inp["x2"], g2, b2), EPS2)):
        with torch.no_grad():
            out, mean, rstd, r = fused_block.linear_residual_ln(*args, eps, inp["vl"], save=True)
            ref = order.residual_ln_rows_order(r, args[4], args[5], eps, inp["valid_len"])
        torch.cuda.synchronize()
        same = [torch.equal(o, rf) for o, rf in zip((out, mean, rstd), ref)]
        ph.check(all(same), f"{fused_block.instance('linear_residual_ln_fwd_bf16', d)}{site}"
                            f"{what_shape}: out, mean, rstd the bits of its LayerNorm order on "
                            f"its own r (tests/torch_bf16_order.py): {same}")
        del out, mean, rstd, r, ref


def plain_attention_function():
    """An autograd Function of the attention's plain forward and backward
    (flash_attention's reference versions), saving only q, k, v, o and the
    lse as PrefixFlashAttention does: one layer's (B, H, S, S) scores live at a
    time, where autograd of the plain masked softmax would keep every
    layer's."""
    import torch

    from chadavit_tpu_torch.ops import flash_attention as fa

    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, valid_len, num_heads):
            out, lse = fa.prefix_flash_attention_reference(q, k, v, valid_len, num_heads,
                                                          return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse, valid_len)
            ctx.num_heads = num_heads
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse, valid_len = ctx.saved_tensors
            dqkv = fa.prefix_flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                                valid_len, ctx.num_heads)
            d = q.shape[2]
            return dqkv[..., :d], dqkv[..., d:2 * d], dqkv[..., 2 * d:], None, None

    return PlainAttention


@contextlib.contextmanager
def plain_attention():
    """Within it, ``flash_attention.prefix_flash_attention`` (the unfused
    layer's attention) runs the plain versions: the reference forward, and
    under grad :func:`plain_attention_function`. Nothing else of the model
    changes."""
    from chadavit_tpu_torch.ops import _launch
    from chadavit_tpu_torch.ops import flash_attention as fa

    function = plain_attention_function()

    def plain(q, k, v, valid_len, num_heads):
        if _launch.needs_grad(q, k, v):
            return function.apply(q, k, v, valid_len, num_heads)
        return fa.prefix_flash_attention_reference(q, k, v, valid_len, num_heads)

    real, fa.prefix_flash_attention = fa.prefix_flash_attention, plain
    try:
        yield
    finally:
        fa.prefix_flash_attention = real


def check_cls_fixture(ph, label, path, dt, cos_bound, abs_bound):
    """The depth-2 model of a JAX CLS fixture (its widths, weights and images
    rebuilt from the seeds in the file) on the card in ``dt``: per-row cosine
    at least ``cos_bound`` and max abs within ``abs_bound(ref)``."""
    import numpy as np
    import torch

    from chadavit_tpu_torch import hub
    from chadavit_tpu_torch.models.chada_vit import chada_vit, random_state_dict

    with np.load(path) as f:
        fx = {key: f[key] for key in f.files}
    widths = {k: int(fx[k]) for k in ("embed_dim", "num_heads") if k in fx}
    model = chada_vit(depth=int(fx["depth"]), return_all_tokens=False,
                      img_size=int(fx["img_size"]), dtype=dt, **widths)
    model.load_state_dict(random_state_dict(model, int(fx["weight_seed"])))
    model = model.to("cuda").eval()
    images = hub.random_images(fx["counts"].tolist(), int(fx["img_size"]), int(fx["image_seed"]))
    xf, ccf = hub.collate_images(images, int(fx["counts"].max()))  # padded to the widest
    with torch.inference_mode():
        cls = model(xf.to("cuda"), ccf.to("cuda"))
    ref = torch.from_numpy(fx["cls"])
    ph.check(cls.dtype == dt and cls.shape == ref.shape
             and bool(torch.isfinite(cls.float()).all()),
             f"{label}CLS {cls.dtype} {tuple(cls.shape)} ({path.name}), finite")
    cls = cls.float().cpu()
    cos = cosine_rows(cls, ref)
    err = (cls - ref).abs().max().item()
    bound = abs_bound(ref)
    spread = (ref - ref[0]).abs().max().item()
    ph.check(cos.min().item() >= cos_bound and err <= bound,
             f"{label}against the JAX fixture: min cosine 1 - {1 - cos.min().item():.2e} "
             f"(>= 1 - {1 - cos_bound:.0e}), max abs {err:.3e} (<= {bound:.3g}); rows differ "
             f"from each other by up to {spread:.3e}")


def check_dino_fixture(ph, label, path, dt, metric_rel, norm_rel, delta_rel):
    """Three DINO steps of a JAX DINO fixture's depth-2 backbone and head (its
    widths, seeded init and batch from the file) on the card in ``dt``: each
    step's metrics within ``metric_rel``, then every student and teacher
    parameter's norm within ``norm_rel`` (parameters float32) and the norm of
    each student parameter's change within ``delta_rel``."""
    import numpy as np
    import torch

    from chadavit_tpu_torch.train.pretrain import (
        DinoPretrainSpec,
        build_dino,
        synthetic_dino_batch,
    )

    with np.load(path) as f:
        dx = {key: f[key] for key in f.files}
    widths = {k: int(dx[k]) for k in ("embed_dim", "num_heads") if k in dx}
    head = {"num_prototypes": int(dx["num_prototypes"])} if "num_prototypes" in dx else {}
    if "max_channels" in dx:  # the crops' planes, where not 10
        head["max_channels"] = int(dx["max_channels"])
    spec = DinoPretrainSpec(
        backbone_kwargs=dict(dict(embed_dim=D, num_heads=H), patch_size=16,
                             return_all_tokens=False, max_number_channels=10,
                             depth=int(dx["depth"]), **widths),
        steps_per_epoch=2, freeze_last_layer=1, clip_grad=3.0,
        warmup_teacher_temperature_epochs=2, dtype=dt, **head)
    state, step, _, _ = build_dino(spec, seed=int(dx["weight_seed"]))
    batch = synthetic_dino_batch(spec, len(dx["counts"]), int(dx["batch_seed"]),
                                 dx["counts"].tolist())
    before = {n: p.detach().clone() for n, p in state.trainable()}
    worst = {}
    for i in range(int(dx["steps"])):
        state, m = step(state, batch)
        for key in ("dino_loss", "center_norm", "lr", "tau", "teacher_temp"):
            worst[key] = max(worst.get(key, 0.0), abs(float(m[key]) / dx[key][i] - 1))
    ph.check(max(worst.values()) <= metric_rel,
             f"{label}{int(dx['steps'])} steps against the JAX DINO fixture ({path.name}), "
             "per-step metrics: worst rel " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
             + f" (tolerance {metric_rel:g})")
    named = {side: {f"{part}.{n}": t for part in ("backbone", "head")
                    for n, t in getattr(state, side)[part].state_dict().items()}
             for side in ("student", "teacher")}
    names = [str(n) for n in dx["names"]]
    all_f32 = all(t.dtype == torch.float32 for side in named.values() for t in side.values())
    norm_err = max(abs(named[side][n].double().norm().item() / dx[f"{side}_norms"][i] - 1)
                   for side in ("student", "teacher") for i, n in enumerate(names))
    delta_err = max(abs((named["student"][n] - before[n]).double().norm().item()
                        / dx["student_delta_norms"][i] - 1)
                    for i, n in enumerate(names)
                    if n in before and dx["student_delta_norms"][i] > 0)
    ph.check(all_f32 and norm_err <= norm_rel and delta_err <= delta_rel,
             f"{label}after {int(dx['steps'])} steps, {len(names)} student and teacher "
             f"parameter norms (all f32: {all_f32}): worst rel {norm_err:.2e} (<= {norm_rel:g}); "
             f"norms of the student's changes: worst rel {delta_err:.2e} (<= {delta_rel:g})")


def chain_launches(runs: int) -> dict:
    """The launches of each layer-chain kernel in ``runs`` layer runs of a
    train path: teacher forward, student forward with the save outputs,
    student backward with its three recomputes."""
    return {"ln_linear_fwd": 3 * runs, "prefix_attention_fwd": 2 * runs,
            "linear_relu_fwd": 3 * runs, "linear_residual_ln_fwd": 5 * runs,
            "prefix_attention_bwd": runs, "layernorm_bwd": 3 * runs, "linear_dgrad": 4 * runs,
            "linear_wgrad": 4 * runs}


def span_recording(build, spans: list):
    """``build`` (build_dino's signature) whose step records each call's
    device span, a pair of CUDA events, into ``spans``."""
    import torch

    def timed_build(*args, **kwargs):
        state, step, model, head = build(*args, **kwargs)

        def timed_step(state_, batch_):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = step(state_, batch_)
            ev[1].record()
            spans.append(ev)
            return out
        return state, timed_step, model, head
    return timed_build


def entry_cfg(extra):
    """The canonical pretrain config with ENTRY and ``extra`` applied, parsed
    as the entry point parses it."""
    from chadavit_tpu_torch.cli import apply_overrides
    from chadavit_tpu_torch.config import load_yaml, parse_pretrain_cfg

    return parse_pretrain_cfg(apply_overrides(load_yaml(str(CANONICAL)), ENTRY + extra))


def run_dir(base) -> Path:
    (run,) = [p for p in (Path(base) / "dino").iterdir() if p.is_dir()]
    return run


def read_logs(base) -> dict:
    """The run's logged metrics by step."""
    with open(run_dir(base) / "training_logs.txt") as f:
        return {r["step"]: r for r in map(json.loads, f)}


def final_ckpt(base) -> Path:
    (ckpt,) = [p for p in run_dir(base).iterdir() if p.is_dir()]
    return ckpt


def step_ckpt(base, step: int) -> Path:
    (ckpt,) = [p for p in run_dir(base).iterdir() if p.name.endswith(f"-step={step}")]
    return ckpt


def differing_entries(a, b, where="state") -> list:
    """The entries of two saved train states that are not equal bit for bit."""
    import torch

    if isinstance(a, dict):
        if set(a) != set(b):
            return [where]
        return [d for k in a for d in differing_entries(a[k], b[k], f"{where}.{k}")]
    if isinstance(a, list):
        if len(a) != len(b):
            return [where]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differing_entries(x, y, f"{where}[{i}]")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [where]
    return [] if a == b else [where]


def demangle(names):
    """C++ names as c++filt gives them, or as they are where it is missing."""
    import shutil

    if not names or shutil.which("c++filt") is None:
        return list(names)
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def padded_seq(channels: int) -> int:
    """The sequence the encoder layers receive for a batch ``channels``
    wide: 1 + 196 c tokens, padded to a multiple of 128."""
    return -(-(1 + N_PATCHES * channels) // 128) * 128


def bf16_step(x: float) -> float:
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def bf16_err(out, ref, rows=None):
    """(max abs error, its bound, cosine) of a bf16 kernel instance's output
    against its plain version, over the first rows[i] rows of image i when
    given: the bound is BF16_STEPS bf16 steps at the reference's largest entry
    for a bf16 output, BF16_F32_REL of it for a float32 one."""
    import torch

    mag_bound = (lambda m: BF16_STEPS * bf16_step(m)) if out.dtype == torch.bfloat16 else (
        lambda m: BF16_F32_REL * m)
    out, ref = out.float(), ref.float()
    if rows is not None:
        out = torch.cat([out[i, :n] for i, n in enumerate(rows)])
        ref = torch.cat([ref[i, :n] for i, n in enumerate(rows)])
    cos = torch.nn.functional.cosine_similarity(out.flatten().double(),
                                                ref.flatten().double(), 0).item()
    return (out - ref).abs().max().item(), mag_bound(ref.abs().max().item()), cos


class Recorder:
    """A namespace of the layer's plain steps that records every call (its
    arguments cloned before the call, and its result), so that each kernel
    can be replayed on the very inputs the layer's chain gives it."""

    def __init__(self, steps):
        self.calls = []
        for name, fn in vars(steps).items():
            setattr(self, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        import torch

        def clone(a):
            return a.clone() if isinstance(a, torch.Tensor) else (
                tuple(clone(t) for t in a) if isinstance(a, tuple) else a)

        def call(*args, **kwargs):
            saved = (clone(args), {k: clone(v) for k, v in kwargs.items()})
            out = fn(*args, **kwargs)
            # the result as it is now: layernorm_bwd's dgb is summed into later
            self.calls.append((name, saved, clone(out)))
            return out
        return call


# the launches of each layer-chain kernel in one encoder layer run: a forward
# without grad, and a finetuned step's forward with its save outputs and its
# backward with the three recomputes (chain_launches less the teacher)
FORWARD_LAUNCHES = {"ln_linear_fwd": 1, "prefix_attention_fwd": 1, "linear_relu_fwd": 1,
                    "linear_residual_ln_fwd": 2}
FINETUNE_LAUNCHES = {"ln_linear_fwd": 2, "prefix_attention_fwd": 1, "linear_relu_fwd": 2,
                     "linear_residual_ln_fwd": 3, "prefix_attention_bwd": 1,
                     "layernorm_bwd": 3, "linear_dgrad": 4, "linear_wgrad": 4}


def expected_launches(instances, *runs) -> dict:
    """Each instance's launches in ``(per-layer launches, layer runs)``
    pairs, 0 for the others."""
    want = {name: 0 for name in instances}
    for per_run, n_runs in runs:
        for name, n in per_run.items():
            want[name] += n * n_runs
    return want


class Tee:
    """A stdout that also keeps what was written (``text``)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    @property
    def text(self) -> str:
        return "".join(self.parts)


def eval_phase(ph, tmp: str, smi: str, instances, reset_launches, read_launches) -> None:
    """Phase 4g: the port's offline evaluation on the card (the module
    docstring's 4g)."""
    import types

    import numpy as np
    import torch

    from chadavit_tpu_torch import main_knn, main_linear
    from chadavit_tpu_torch.cli import apply_overrides, load_backbone_for_eval
    from chadavit_tpu_torch.config import load_yaml, parse_knn_cfg, parse_linear_cfg, \
        parse_regression_cfg
    from chadavit_tpu_torch.data.disk_dataset import generate
    from chadavit_tpu_torch.data.pipeline import to_device
    from chadavit_tpu_torch.eval.features import extract_features, make_feature_fn
    from chadavit_tpu_torch.models.import_torch import load_jax_npz, state_dict_from_jax_params
    from chadavit_tpu_torch.utils.misc import resolve_device

    t_phase = time.perf_counter()
    if not STUDY_NPZ.is_file():
        ph.check(False, f"{STUDY_NPZ} is in the checkout")
        return
    root = f"{tmp}/manifest"
    generate(root, EVAL_BANK + EVAL_QUERIES, num_classes=7, seed=5, workers=4, image_subdir="",
             val_fraction=EVAL_QUERIES / (EVAL_BANK + EVAL_QUERIES))
    data = [f"data.train_path={root}", f"data.val_path={root}",
            f"pretrained_feature_extractor={STUDY_NPZ}"]
    log(f"  wrote {EVAL_BANK} + {EVAL_QUERIES} images in {time.perf_counter() - t_phase:.2f} s")

    def expected(*runs) -> dict:
        return expected_launches(instances, *runs)

    # (a) the kNN study YAML through main_knn's command line
    knn_over = [*data, "data.sample_ratio=1.0"]
    cfg_k = parse_knn_cfg(apply_overrides(load_yaml(str(KNN_YAML)), list(knn_over)))
    bank_loader, query_loader = main_knn.knn_loaders(cfg_k)
    n_batches = len(bank_loader) + len(query_loader)
    t = time.perf_counter()
    reset_launches()
    with contextlib.chdir(tmp):
        out = main_knn.main(["--config-path", str(KNN_YAML.parent), "--config-name",
                             KNN_YAML.name, *knn_over])
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t
    launches = read_launches()
    model = out["model"]
    depth = len(model.blocks)
    rows = out["rows"]
    grid = cfg_k.knn_eval_offline
    want_rows = [[f, d, k, T] for f in grid.feature_type for k in grid.k
                 for d in grid.distance_function
                 for T in (grid.temperature if d == "cosine" else [None])]
    with open(os.path.join(tmp, out["csv"]), newline="") as f:
        header = f.readline().strip().split(",")
    ph.check(header == main_knn.CSV_HEADER and [r[:4] for r in rows] == want_rows
             and all(0.0 <= r[4] <= 100.0 and 0.0 <= r[5] <= 100.0 for r in rows),
             f"(a) main_knn on {KNN_YAML.name} from {STUDY_NPZ.name}: "
             + "; ".join(f"k={r[2]} T={r[3]}: acc@1 {r[4]:.2f} acc@5 {r[5]:.2f}" for r in rows)
             + f" ({EVAL_BANK} bank, {EVAL_QUERIES} queries, {knn_s:.2f} s with set-up)")
    want = expected((FORWARD_LAUNCHES, depth * n_batches))
    ph.check(launches == want,
             f"kNN launches: only the D 192 forward instances, {depth} layers x {n_batches} "
             f"batches: {dict((k, v) for k, v in launches.items() if v)}")
    widths = []

    def plain_fn(m, x, c):
        widths.append(x.shape[1])
        return plain_backbone(m, x, c)

    for what, loader, feats in (("bank", bank_loader, out["features"]["backbone"][0]),
                                ("queries", query_loader, out["features"]["backbone"][1])):
        plain, _ = extract_features(loader, plain_fn, model)
        cos = cosine_rows(torch.from_numpy(feats), torch.from_numpy(plain))
        err = float(np.abs(feats - plain).max())
        ph.check(feats.shape == plain.shape == (len(loader.dataset), D)
                 and cos.min().item() >= SERVED_COS,
                 f"kNN {what} features {feats.shape}, kernels against the plain versions: min "
                 f"cosine 1 - {1 - cos.min().item():.2e} (>= 1 - {1 - SERVED_COS:.0e}), "
                 f"max abs {err:.3e}")
    ph.check(set(widths) == {10}, f"bucket_round 10: every batch 10 channels wide: {sorted(set(widths))}")
    feature_fn = make_feature_fn(model, "multi_channels")
    t = time.perf_counter()
    extract_features(bank_loader, feature_fn, model)
    extract_features(query_loader, feature_fn, model)
    wall_rate = (EVAL_BANK + EVAL_QUERIES) / (time.perf_counter() - t)
    # the card alone: the bank's batches as the loader pads them (bucket_round
    # 10), and a batch whose images all hold 10 channels
    dev = next(model.parameters()).device
    bank_ms, valid = 0.0, []
    with torch.inference_mode():
        for b in bank_loader:
            xb = torch.from_numpy(b["images"]).to(dev)
            cb = torch.from_numpy(b["channel_counts"]).to(dev)
            bank_ms += time_ms(lambda: model(xb, cb), iters=3, warmup=1)
            valid += b["channel_counts"].tolist()
        bsz = cfg_k.optimizer.batch_size
        x = torch.rand((bsz, 10, model.img_size, model.img_size),
                       generator=torch.Generator(device=dev).manual_seed(7), device=dev)
        c = torch.full((bsz,), 10, dtype=torch.int32, device=dev)
        full_ms = time_ms(lambda: model(x, c), iters=3, warmup=1)
    log(f"  kNN embeddings/s, f32, batch {bsz}, every batch padded to 10 channels (S_pad "
        f"2048): {wall_rate:.1f} with the host loader (decode, resize, upload: the bank and "
        f"the queries); on the card alone {1e3 * len(valid) / bank_ms:.1f} over the bank "
        f"({len(valid)} images of {np.mean(valid):.2f} channels on average, {bank_ms:.2f} ms), "
        f"{1e3 * bsz / full_ms:.1f} at 10 channels each ({full_ms:.2f} ms a batch) ({smi})")
    del out, model, x, c, xb, cb
    torch.cuda.empty_cache()

    # (b) the bbbc048 linear probe through main_linear's command line
    def probe(yaml, parse, over):
        args = main_linear.parse_args(["--config-path", str(yaml.parent), "--config-name",
                                       yaml.name, *over])
        cfg = parse(main_linear.load_cfg(args))
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.chdir(tmp):
            run = main_linear.run_probe(cfg, task="regression" if parse is parse_regression_cfg
                                        else "classification")
        torch.cuda.synchronize()
        return cfg, run, read_launches(), time.perf_counter() - t0

    lin = [*data, "optimizer.batch_size=32"]
    cfg_z, run, launches, lin_s = probe(LINEAR_YAML, parse_linear_cfg,
                                        [*lin, f"max_steps={PROBE_FROZEN_STEPS}"])
    ref_sd = state_dict_from_jax_params(load_jax_npz(str(STUDY_NPZ)))
    moved = [k for k, v in run.state.backbone.state_dict().items()
             if not torch.equal(v.cpu(), ref_sd[k])]
    suite = ("acc1", "acc5", "precision", "recall", "f1")
    ph.check(run.steps == PROBE_FROZEN_STEPS and all(math.isfinite(v) for v in run.losses)
             and not moved and all(k in run.results and math.isfinite(run.results[k])
                                   for k in suite),
             f"(b) main_linear on {LINEAR_YAML.parent.name}/{LINEAR_YAML.name}, frozen, "
             f"{run.steps} steps of {cfg_z.optimizer.batch_size}: losses {run.losses}, the "
             f"backbone bit for bit the .npz's (tensors moved: {moved[:3]}); validation "
             f"{ {k: round(v, 4) for k, v in run.results.items()} } ({lin_s:.2f} s with set-up)")
    want = expected((FORWARD_LAUNCHES, depth * (run.steps + run.val_batches)))
    ph.check(launches == want, f"frozen probe launches: the forward instances, {depth} layers "
             f"x ({run.steps} steps + {run.val_batches} validation batches): "
             f"{dict((k, v) for k, v in launches.items() if v)}")
    del run
    ft = [*lin, "finetune=true", "layer_decay=0.75"]
    cfg_f, run, launches, ft_s = probe(LINEAR_YAML, parse_linear_cfg,
                                       [*ft, f"max_steps={PROBE_FINETUNE_STEPS}"])
    ph.check(run.steps == PROBE_FINETUNE_STEPS and all(math.isfinite(v) for v in run.losses),
             f"finetune with layer_decay 0.75, {run.steps} steps: losses {run.losses}, "
             f"validation { {k: round(v, 4) for k, v in run.results.items()} } "
             f"({ft_s:.2f} s with set-up)")
    want = expected((FINETUNE_LAUNCHES, depth * run.steps),
                    (FORWARD_LAUNCHES, depth * run.val_batches))
    ph.check(launches == want, f"finetune launches: K2 and K4 {depth} a step, with the "
             f"forward's, and {run.val_batches} validation batches' forward: "
             f"{dict((k, v) for k, v in launches.items() if v)}")
    del run

    # step 1 again from one state, kernels against the plain chains
    train_loader, _ = main_linear.probe_loaders(cfg_f)
    batch = to_device({k: next(iter(train_loader))[k]
                       for k in ("images", "channel_counts", "labels")}, resolve_device())
    states = []
    for plain in (False, True):
        model = load_backbone_for_eval(cfg_f)
        if plain:
            model.forward = types.MethodType(plain_chain_backbone, model)
        states.append(main_linear.build_probe(cfg_f, model, len(train_loader))[:2])
    (st_k, step_k), (st_p, step_p) = states
    reset_launches()
    st_k, m_k = step_k(st_k, batch)
    torch.cuda.synchronize()
    after_k = read_launches()
    st_p, m_p = step_p(st_p, batch)
    torch.cuda.synchronize()
    ph.check(after_k == expected((FINETUNE_LAUNCHES, depth)) and read_launches() == after_k,
             f"finetune step 1: K2 and K4 {depth} times, the plain step none")
    loss_rel = abs(float(m_p["loss"]) / float(m_k["loss"]) - 1)
    ph.check(loss_rel <= TRAIN_LOSS_REL,
             f"finetune step 1, kernels against the plain chains: loss {float(m_k['loss']):.6f}, "
             f"rel {loss_rel:.2e} (<= {TRAIN_LOSS_REL:g})")

    def first_moments(st):
        """Each trainable tensor's Adam first moment, (1 - b1) g after one
        step: the step's direction before Adam's normalisation, as 4b reads
        LARS's momentum."""
        names = [n for n, _ in st.trainable()]
        out_ = {}
        for group, gs in st.opt_state.items():
            gs = gs[0] if not hasattr(gs, "mu") else gs  # the layer-decay chain
            out_.update(zip([n for n in names if n.split(".", 1)[0] == group], gs.mu))
        return [out_[n] for n in names]

    check_updates(ph, "finetune step 1", [n for n, _ in st_k.trainable()], first_moments(st_k),
                  first_moments(st_p), types.SimpleNamespace(freeze_last_layer=0),
                  TRAIN_UPDATE_COS, of="Adam's first moments")

    def step_ms(step, st, n=3):
        step(st, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(st, batch)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    ft_ms = step_ms(step_k, st_k)
    st_z, step_z = main_linear.build_probe(cfg_z, st_k.backbone, len(train_loader))[:2]
    frozen_ms = step_ms(step_z, st_z)
    log(f"  probe steps at batch {batch['images'].shape[0]}, 10 channels wide (S_pad 2048), "
        f"f32, host clock: frozen {frozen_ms:.2f} ms, finetune {ft_ms:.2f} ms a step ({smi})")
    del states, st_k, st_p, st_z, step_k, step_p, step_z, batch
    torch.cuda.empty_cache()

    # (c) the transloc regression probe on synthetic data
    cfg_r, run, launches, reg_s = probe(
        REGRESSION_YAML, parse_regression_cfg,
        [f"pretrained_feature_extractor={STUDY_NPZ}", "data.dataset=synthetic",
         f"max_steps={PROBE_FROZEN_STEPS}"])
    ph.check(run.steps == PROBE_FROZEN_STEPS and all(math.isfinite(v) for v in run.losses)
             and set(run.results) == {"mse", "mae", "r2", "pearson"}
             and all(math.isfinite(v) for v in run.results.values())
             and launches == expected((FORWARD_LAUNCHES, depth * (run.steps + run.val_batches))),
             f"(c) main_regression on {REGRESSION_YAML.parent.name}/{REGRESSION_YAML.name}, "
             f"synthetic, {run.steps} steps of {cfg_r.optimizer.batch_size}: losses "
             f"{[round(v, 4) for v in run.losses]}, "
             f"{ {k: round(v, 4) for k, v in run.results.items()} }, forward launches "
             f"{depth} x ({run.steps} + {run.val_batches}) ({reg_s:.2f} s with set-up)")
    del run
    torch.cuda.empty_cache()
    log(f"  phase 4g: kNN {knn_s:.1f} s, frozen probe {lin_s:.1f} s, finetune {ft_s:.1f} s, "
        f"regression {reg_s:.1f} s; {time.perf_counter() - t_phase:.1f} s in all")


def validation_phase(ph, tmp: str, smi: str, instances, reset_launches, read_launches) -> None:
    """Phase 4h: validation during pretraining, main_umap and main_attn on
    the card (the module docstring's 4h), over phase 4g's manifest."""
    import importlib.util

    import numpy as np
    import torch

    from chadavit_tpu_torch import main_attn, main_knn, main_pretrain, main_umap
    from chadavit_tpu_torch.cli import apply_overrides, load_backbone_for_eval
    from chadavit_tpu_torch.config import load_yaml, parse_knn_cfg, parse_pretrain_cfg
    from chadavit_tpu_torch.data.classification import prepare_transforms
    from chadavit_tpu_torch.data.datasets import prepare_datasets
    from chadavit_tpu_torch.data.pipeline import HostLoader
    from chadavit_tpu_torch.eval.features import extract_features, make_feature_fn
    from chadavit_tpu_torch.eval.knn import knn_classify
    from chadavit_tpu_torch.ops.fused_block import fused_encoder_block_reference
    from chadavit_tpu_torch.train import loop
    from chadavit_tpu_torch.train.dino_step import make_dino_eval_loss
    from chadavit_tpu_torch.train.pretrain import build_dino
    from chadavit_tpu_torch.utils import auto_umap
    from chadavit_tpu_torch.utils.checkpoint import restore_state
    from chadavit_tpu_torch.utils.misc import resolve_device, resolve_seed

    t_phase = time.perf_counter()
    root = f"{tmp}/manifest"
    if not os.path.isfile(f"{root}/test.csv"):
        ph.check(False, f"phase 4g's manifest is at {root}")
        return
    dev = resolve_device()
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("matplotlib", "sklearn", "umap")}
    log(f"  on this machine: {', '.join(f'{m} {have[m]}' for m in have)}")

    def bf16_names(per_run):
        return {f"{k}_bf16": v for k, v in per_run.items()}

    # (a) dino_idr10k.yaml, one epoch, then its validation
    over = [f"data.train_path={root}", f"data.val_path={root}", *VAL_ENTRY,
            f"checkpoint.dir={tmp}/v"]
    cfg = parse_pretrain_cfg(apply_overrides(load_yaml(str(IDR10K)), list(over)))
    seed = resolve_seed(cfg)
    tee = Tee(sys.stdout)
    reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        metrics = main_pretrain.main(["--config-path", str(IDR10K.parent), "--config-name",
                                      IDR10K.name, *over])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = read_launches()
    with open(run_dir(f"{tmp}/v") / "training_logs.txt") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "dino_loss" in r]
    (logged,) = [r for r in records if "val_knn_top1" in r] or [{}]
    ph.check(len(steps) == EVAL_BANK // cfg.optimizer.batch_size
             and all(math.isfinite(r["dino_loss"]) for r in steps)
             and all(k in logged and math.isfinite(logged[k]) and metrics[k] == logged[k]
                     for k in VAL_METRICS) and logged.get("step") == len(steps),
             f"(a) main_pretrain on {IDR10K.name} with {' '.join(VAL_ENTRY[2:])}: "
             f"{len(steps)} bf16 steps (dino_loss {[round(r['dino_loss'], 4) for r in steps]}), "
             f"then at step {logged.get('step')}: "
             + ", ".join(f"{k} {logged.get(k)}" for k in VAL_METRICS)
             + f" ({run_s:.2f} s with set-up)")
    ph.check("eval decoder: native" in tee.text and "NativeEvalLoader" in tee.text,
             "the decoder lines: " + "; ".join(
                 ln for ln in tee.text.splitlines() if "decoder" in ln))

    steps_per_epoch = len(loop.build_pretrain_loader(cfg, seed=seed))
    spec = loop.spec_from_cfg(cfg, steps_per_epoch)
    state, _, _, _ = build_dino(spec, device=str(dev), seed=seed,
                                device_augmentations=[dict(a) for a in cfg.augmentations])
    restore_state(str(final_ckpt(f"{tmp}/v")), state)
    val = loop.Validation(cfg, spec, steps_per_epoch, dev, seed, f"{tmp}/v_umap")
    loaders = (("bank", val.bank_loader), ("queries", val.val_loader))
    ph.check(all(type(ld).__name__ == "NativeEvalLoader" for _, ld in loaders),
             "the validation reads through the C++ eval loader: "
             + ", ".join(f"{w} {type(ld).__name__} of {len(ld)} batches" for w, ld in loaders))
    depth = len(state.student["backbone"].blocks)
    n_fwd = len(val.bank_loader) + 3 * len(val.val_loader)  # bank, queries, two ssl sides
    want = expected_launches(instances, (bf16_names(chain_launches(depth * len(steps))), 1),
                             (bf16_names(FORWARD_LAUNCHES), depth * n_fwd))
    ph.check(launches == want,
             f"(a) launches: {len(steps)} train steps' chain and {n_fwd} forward batches x "
             f"{depth} layers (bank, queries, the SSL loss's student and teacher): "
             f"{dict((k, v) for k, v in launches.items() if v)}")

    feats = {w: val.features(state, ld) for w, ld in loaders}
    top = knn_classify(feats["bank"][0], feats["bank"][1], feats["queries"][0],
                       feats["queries"][1], k=val.k, distance_fx=val.distance, device=dev)
    ph.check(top == (logged.get("val_knn_top1"), logged.get("val_knn_top5")),
             f"the offline knn_classify on the final checkpoint's student over the same "
             f"loaders: top1 {top[0]}, top5 {top[1]}, equal to the logged")
    backbone = state.student["backbone"]
    for w, ld in loaders:
        plain, _ = extract_features(ld, plain_backbone, backbone)
        got = feats[w][0]
        cos = cosine_rows(torch.from_numpy(got), torch.from_numpy(plain))
        ph.check(got.shape == plain.shape == (len(ld.rows), D)
                 and cos.min().item() >= SERVED_BF16_COS,
                 f"bf16 {w} features {got.shape} against the plain versions: min cosine 1 - "
                 f"{1 - cos.min().item():.2e} (>= 1 - {1 - SERVED_BF16_COS:.0e}), max abs "
                 f"{float(np.abs(got - plain).max()):.3e}")
    again = val.ssl_loss(state, 0)
    plain_loss = val.ssl_loss(state, 0, eval_loss=make_dino_eval_loss(
        plain_backbone, lambda h, f: h(f), val.step_cfg))
    rel = abs(plain_loss / logged.get("dino_loss_val", float("nan")) - 1)
    ph.check(again == logged.get("dino_loss_val") and rel <= TRAIN_BF16_LOSS_REL,
             f"dino_loss_val {logged.get('dino_loss_val')}: recomputed on the same views "
             f"{again}; the plain chains' {plain_loss}, rel {rel:.2e} (<= "
             f"{TRAIN_BF16_LOSS_REL:g})")
    del state, val, feats, backbone
    torch.cuda.empty_cache()

    # the C++ eval loader against the host eval loader, on the study checkpoint
    cfg_k = parse_knn_cfg(apply_overrides(load_yaml(str(KNN_YAML)), [
        f"data.train_path={root}", f"data.val_path={root}",
        f"pretrained_feature_extractor={STUDY_NPZ}", "data.sample_ratio=1.0"]))
    study = load_backbone_for_eval(cfg_k)
    host_bank, _ = main_knn.knn_loaders(cfg_k)
    cfg_k.native_loader = True
    native_bank, _ = main_knn.knn_loaders(cfg_k)
    fn = make_feature_fn(study, "multi_channels")
    rates = {}
    for what, ld in (("host", host_bank), ("native", native_bank)):
        t = time.perf_counter()
        extract_features(ld, fn, study)
        rates[what] = EVAL_BANK / (time.perf_counter() - t)
    crop = cfg_k.data.get("augmentations", {}).get("crop_size", 224)
    _, t_val = prepare_transforms(cfg_k.data.dataset, crop)
    host_in_order = HostLoader(
        prepare_datasets(cfg_k.data.dataset, transform=t_val, train_path=root),
        batch_size=cfg_k.optimizer.batch_size,
        max_channels=cfg_k.backbone.kwargs.max_number_channels,
        num_workers=cfg_k.data.num_workers, shuffle=False, drop_last=False,
        bucket_by_channels=False)
    worst, same = 0.0, True
    for nb, hb in zip(native_bank, host_in_order, strict=True):
        same &= (np.array_equal(nb["channel_counts"], hb["channel_counts"])
                 and np.array_equal(nb["labels"], hb["labels"]))
        worst = max(worst, float(np.abs(nb["images"] - hb["images"]).max()))
    ph.check(same and worst <= NATIVE_TOL,
             f"the C++ eval loader's {len(native_bank)} bank batches against the host "
             f"path's in file order ({crop} px, {native_bank.max_channels} channels wide): "
             f"counts and labels equal "
             f"{same}, max abs {worst:.2e} (<= {NATIVE_TOL:g})")
    log(f"  eval embeddings/s over 4g's bank ({EVAL_BANK} images, f32 study checkpoint, batch "
        f"{cfg_k.optimizer.batch_size}, {native_bank.max_channels} channels wide): C++ eval loader "
        f"{rates['native']:.1f}, host eval loader {rates['host']:.1f} "
        f"({rates['native'] / rates['host']:.2f}x) ({smi})")
    del study, host_bank, native_bank, host_in_order
    torch.cuda.empty_cache()

    # (b) main_umap on the study checkpoint over 4g's bank
    reset_launches()
    t = time.perf_counter()
    with contextlib.chdir(tmp):
        out = main_umap.main(["--config-path", str(KNN_YAML.parent), "--config-name",
                              KNN_YAML.name, f"data.train_path={root}",
                              f"pretrained_feature_extractor={STUDY_NPZ}",
                              "data.sample_ratio=1.0", "native_loader=true", "name=study"])
    torch.cuda.synchronize()
    umap_s = time.perf_counter() - t
    launches = read_launches()
    n_batches = -(-EVAL_BANK // cfg_k.optimizer.batch_size)
    t = time.perf_counter()
    emb = auto_umap.tsne(out["features"], device=dev)
    tsne_s = time.perf_counter() - t
    trust = auto_umap.trustworthiness(out["features"], emb, 5)
    png = Path(tmp) / "study_umap.png"
    ph.check(emb.shape == (EVAL_BANK, 2) and np.isfinite(emb).all() and 0 < trust <= 1
             and (have["umap"] or np.array_equal(emb, out["embedding"]))
             and png.is_file() == have["matplotlib"] and launches == expected_launches(
                 instances, (FORWARD_LAUNCHES, len(out["model"].blocks) * n_batches)),
             f"(b) main_umap on {STUDY_NPZ.name} over the bank: the t-SNE on the card "
             f"{tsne_s:.2f} s for {EVAL_BANK} points (the run {umap_s:.2f} s with set-up), "
             f"trustworthiness at k 5 {trust:.4f}; wrote {out['written']}; forward launches "
             f"{dict((k, v) for k, v in launches.items() if v)} ({smi})")
    del out
    torch.cuda.empty_cache()

    # (c) main_attn on one generated plane
    plane = prepare_datasets("bbbc048", train_path=root).file_list[0][2][0]
    reset_launches()
    t = time.perf_counter()
    with contextlib.chdir(tmp):
        res = main_attn.main(["--config-path", str(KNN_YAML.parent), "--config-name",
                              KNN_YAML.name, f"image_path={plane}",
                              f"pretrained_feature_extractor={STUDY_NPZ}",
                              f"output_dir={tmp}/attn", f"threshold={ATTN_THRESHOLD}"])
    torch.cuda.synchronize()
    attn_s = time.perf_counter() - t
    launches = read_launches()
    model = res["model"]
    heads = res["attention"].shape[1]
    want_files = sorted(["img.png", "attn-mean.png"]
                        + [f"attn-head{j}.png" for j in range(heads)]
                        + [f"mask_th{ATTN_THRESHOLD}_head{j}.png" for j in range(heads)])
    with torch.inference_mode():
        x = torch.from_numpy(main_attn.load_image(plane, model.img_size, model.patch_size))
        x = x[None, None].to(dev)
        emb_, mask = model.tokenize(x, torch.ones(1, dtype=torch.int32, device=dev),
                                    max_channels=1)
        vl = torch.full((1,), emb_.shape[1], dtype=torch.int32, device=dev)
        for blk in model.blocks[:-1]:
            emb_ = fused_encoder_block_reference(emb_, vl, *blk.weights(), blk.num_heads,
                                                 blk.layer_norm_eps, blk.layer_norm_eps)
        ref = model.blocks[-1](emb_, mask, valid_len=vl, return_attention=True).float().cpu()
    got = torch.from_numpy(res["attention"])
    cos = cosine_rows(got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1]))
    ph.check(sorted(os.listdir(f"{tmp}/attn")) == want_files
             and cos.min().item() >= ATTN_COS
             and launches == expected_launches(instances,
                                               (FORWARD_LAUNCHES, len(model.blocks) - 1)),
             f"(c) main_attn on {Path(plane).name} at {x.shape[-1]} px, threshold "
             f"{ATTN_THRESHOLD}: wrote {sorted(os.listdir(f'{tmp}/attn'))}; the {heads} heads' "
             f"weights {tuple(got.shape)} against the plain route: min row cosine 1 - "
             f"{1 - cos.min().item():.2e} (>= 1 - {1 - ATTN_COS:.0e}), max abs "
             f"{(got - ref).abs().max().item():.2e}; launches "
             f"{dict((k, v) for k, v in launches.items() if v)} (the first "
             f"{len(model.blocks) - 1} "
             f"layers' forward; the last returns its weights through the plain attention) "
             f"({attn_s:.2f} s with set-up)")
    del res, model
    torch.cuda.empty_cache()
    log(f"  phase 4h: validation run {run_s:.1f} s, main_umap {umap_s:.1f} s, main_attn "
        f"{attn_s:.1f} s; {time.perf_counter() - t_phase:.1f} s in all")


def main() -> int:
    failures: list = []
    import numpy as np
    import torch

    # ---- 0. guard -----------------------------------------------------------
    with Phase("0 guard", failures):
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device; the port's smoke run has no CPU path",
                  file=sys.stderr, flush=True)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = nvidia_smi_line()
        print(smi, flush=True)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    import torch.nn.functional as F

    from chadavit_tpu_torch import hub
    from chadavit_tpu_torch.models.chada_vit import chada_vit, random_state_dict
    from chadavit_tpu_torch.ops import _build, _launch, fused_block
    from chadavit_tpu_torch.ops import flash_attention as fa
    from chadavit_tpu_torch.train.pretrain import (
        DinoPretrainSpec,
        build_dino,
        synthetic_dino_batch,
    )

    dev = torch.device("cuda")
    fb_cu = "chadavit_tpu_torch/csrc/fused_block.cu"
    fbb_cu = "chadavit_tpu_torch/csrc/fused_block_bwd.cu"
    tc_cu = "chadavit_tpu_torch/csrc/linear_bwd_bf16.cu"
    fwd_tc_cu = "chadavit_tpu_torch/csrc/linear_fwd_bf16.cu"
    wgmma_cu = "chadavit_tpu_torch/csrc/linear_wgmma_bf16.cu"
    attn_cu = "chadavit_tpu_torch/csrc/prefix_attention.cu"
    attn_bwd_cu = "chadavit_tpu_torch/csrc/prefix_attention_bwd.cu"
    k1, k2 = "chadavit_tpu/ops/fused_block.py:91", "chadavit_tpu/ops/fused_block.py:211"
    from chadavit_tpu_torch.ops import layernorm as ln

    ln_cu = "chadavit_tpu_torch/csrc/layernorm.cu"
    kernels = {  # name -> wrapper, source, the TPU kernel it replaces
        "ln_linear_fwd": (fused_block.ln_linear, fb_cu, k1),
        "prefix_attention_fwd": (fa.prefix_flash_attention, attn_cu,
                                 "chadavit_tpu/ops/flash_attention.py:103"),
        "linear_relu_fwd": (fused_block.linear_relu, fb_cu, k1),
        "linear_residual_ln_fwd": (fused_block.linear_residual_ln, fb_cu, k1),
        "prefix_attention_bwd": (fa.prefix_attention_bwd, attn_bwd_cu,
                                 "chadavit_tpu/ops/flash_attention.py:157"),
        "layernorm_bwd": (fused_block.layernorm_bwd, fbb_cu, k2),
        "linear_dgrad": (fused_block.linear_dgrad, fbb_cu, k2),
        "linear_wgrad": (fused_block.linear_wgrad, fbb_cu, k2),
        "ln_fwd": (ln.ln_fwd, ln_cu, "chadavit_tpu/ops/layernorm.py:38"),
        "ln_bwd": (ln.ln_bwd, ln_cu, "chadavit_tpu/ops/layernorm.py:55"),
    }
    # every kernel instance: the float32 one keeps the kernel's name, the
    # bfloat16 one ends in _bf16 (its C entry point)
    bf16 = torch.bfloat16
    instances = {name + tag: (wrapper, src, replaces, dt)
                 for tag, dt in (("", torch.float32), ("_bf16", bf16))
                 for name, (wrapper, src, replaces) in kernels.items()}
    attn_tc_cu = "chadavit_tpu_torch/csrc/prefix_attention_bf16.cu"
    for name, src in (("ln_linear_fwd_bf16", fwd_tc_cu), ("linear_relu_fwd_bf16", fwd_tc_cu),
                      ("linear_residual_ln_fwd_bf16", fwd_tc_cu),
                      ("linear_dgrad_bf16", tc_cu), ("linear_wgrad_bf16", tc_cu),
                      ("prefix_attention_fwd_bf16", attn_tc_cu),
                      ("prefix_attention_bwd_bf16", attn_tc_cu)):  # the tensor-core kernels
        wrapper, _, replaces, dt = instances[name]
        instances[name] = (wrapper, src, replaces, dt)
    # the head-64 instances of the attention kernels (ChAdaViT-B/16): the same
    # entry points, counted under their own names (flash_attention.instance)
    for name in ("prefix_attention_fwd", "prefix_attention_bwd",
                 "prefix_attention_fwd_bf16", "prefix_attention_bwd_bf16"):
        instances[fa.instance(name, 64)] = instances[name]
    # the layer chain's D 768 instances (ChAdaViT-B/16 where the JAX gate takes
    # the fused layer): the same entry points, counted as name_d768
    # (fused_block.instance)
    for name in CHAIN_ENTRIES:
        for tag in ("", "_bf16"):
            instances[fused_block.instance(name + tag, D16)] = instances[name + tag]
    for name in ("ln_linear_fwd_bf16", "linear_relu_fwd_bf16", "linear_residual_ln_fwd_bf16",
                 "linear_dgrad_bf16", "linear_wgrad_bf16"):  # wgmma and TMA at D 768
        wrapper, _, replaces, dt = instances[name]
        instances[fused_block.instance(name, D16)] = (wrapper, wgmma_cu, replaces, dt)
    # the smoke configs' width: the attention's head-32 instances and the layer
    # chain's D 64 ones, the same entry points and sources as at head 96 and
    # D 192, counted as name_hd32 and name_d64
    smoke_instances = [fa.instance(name + tag, 32) for tag in ("", "_bf16")
                       for name in ("prefix_attention_fwd", "prefix_attention_bwd")]
    smoke_instances += [fused_block.instance(name + tag, D64) for tag in ("", "_bf16")
                        for name in CHAIN_ENTRIES]
    for name in smoke_instances:
        instances[name] = instances[name.removesuffix("_hd32").removesuffix("_d64")]
    stats = {name: {"max_abs_err": 0.0} for name in instances}

    def reset_launches():
        _launch.LAUNCHES.clear()

    def read_launches():
        return {name: _launch.LAUNCHES[name] for name in instances}

    # ---- 1. build -----------------------------------------------------------
    with Phase("1 build", failures) as ph:
        cold = not (_build.BUILD_DIR / _build.source_hash()).exists()
        t = time.perf_counter()
        # every kernel of the tensor-core sources and of the float32
        # attention forward and backward (K3, K4), the float32 ln_linear
        # (K1a), linear_relu (K1c) and linear_residual_ln (K1b) of
        # fused_block.cu (at D 768 the 128-row GEMM and the two row passes),
        # the two passes of layernorm_bwd (K2a) and of the float32 linear_wgrad
        # (K2c) and the float32 linear_dgrad (K2b) of fused_block_bwd.cu, and
        # the instances of ln_bwd (K6, layernorm.cu)
        ptxas_sources = {fwd_tc_cu: (), tc_cu: (), wgmma_cu: (), attn_tc_cu: (), attn_cu: (),
                         attn_bwd_cu: (),
                         fb_cu: ("ln_linear", "linear_relu", "linear_residual_ln", "gemm128",
                                 "ln_rows_f32", "res_ln_rows"),
                         fbb_cu: ("layernorm_bwd", "layernorm_bwd_wide_bf16",
                                  "reduce_ln_splits", "linear_wgrad",
                                  "reduce_wgrad_splits", "linear_wgrad_stream",
                                  "reduce_wgrad_stream", "ln_rows_saved_f32", "linear_dgrad",
                                  "linear_dgrad_stream", "reduce_dgrad_stream", "dgrad_list"),
                         ln_cu: ("ln_bwd",)}
        ptxas = [_build.ptxas_report(Path(src).name)  # beside the build
                 for src in ptxas_sources]
        head_kernels = {  # the attention kernels' head-64 and head-32 instances
            attn_cu: ["prefix_attention_kernel"],
            attn_bwd_cu: ["attention_bwd_prep_kernel", "attention_bwd_kernel"],
            attn_tc_cu: ["attention_fwd_bf16_kernel", "attention_bwd_prep_kernel",
                         "attention_dkdv_bf16_kernel", "attention_dq_bf16_kernel"]}
        # the bf16 K3 and K4's dk/dv and dq at head 64: wgmma kernels of their
        # own, not templates on the head width
        head64_wgmma = ["attention_fwd_wgmma_kernel", "attention_dkdv_wgmma_kernel",
                        "attention_dq_wgmma_kernel"]
        _build.library()
        ph.check(True, f"{'cold' if cold else 'warm'} build of {len(_build.sources())} "
                       f"sources: {time.perf_counter() - t:.2f} s")
        # registers, shared memory and spills of those kernels
        seen768, seen64 = [], []
        for (src, only), proc in zip(ptxas_sources.items(), ptxas):
            report = _build.ptxas_lines(proc)
            names = demangle([k["name"] for k in report])
            if only:
                kept = [i for i, n in enumerate(names) if any(o + "_kernel" in n for o in only)]
                report, names = [report[i] for i in kept], [names[i] for i in kept]
            if src == ln_cu:  # ln_bwd's instances at D 192, the model's width
                kept = [i for i, n in enumerate(names) if "16, 3>" in n]
                report, names = [report[i] for i in kept], [names[i] for i in kept]
            for k, short in zip(report, names):
                log(f"  ptxas {short}: {k.get('registers')} registers, {k.get('smem')} bytes "
                    f"static smem, spill stores {k.get('spill_stores')} B, spill loads "
                    f"{k.get('spill_loads')} B")
            ph.check(len(report) > 0 and all(k.get("spill_stores") == 0 == k.get("spill_loads")
                                             for k in report),
                     f"{Path(src).name}: {len(report)} kernels"
                     f"{' (' + ', '.join(only) + ')' if only else ''}, none spills")
            serialized = [n for k, n in zip(report, names) if k.get("serialized")]
            ph.check(not serialized, f"{Path(src).name}: no wgmma serialized by ptxas "
                                     f"(C7510-C7520){': ' + ', '.join(serialized) if serialized else ''}")
            short_names = [n.replace("(anonymous namespace)::", "").removeprefix("void ")
                           for n in names]
            seen768.extend(p_ for p_ in D768_KERNELS if any(n.startswith(p_) for n in short_names))
            seen64.extend(p_ for p_ in D64_KERNELS if any(n.startswith(p_) for n in short_names))
            # the attention's head-64 and head-32 instances among them
            for hd in (64, 32) if src in head_kernels else ():
                # (mangled, a template argument 64 reads ILi64E)
                want = head_kernels[src]
                if src == attn_tc_cu and hd == 64:  # the prep pass, then the wgmma kernels
                    want = want[1:2] + head64_wgmma
                found = [k_ for k_ in want
                         if any(f"{k_}ILi{hd}E" in k["name"] or (k_ in head64_wgmma and
                                                                 k_ in k["name"])
                                for k in report)]
                ph.check(found == want,
                         f"{Path(src).name}: head-{hd} instances "
                         f"{[k_ if k_ in head64_wgmma else f'{k_}<{hd}>' for k_ in found]} "
                         f"(want {len(want)}), none spills")

        # the head-64 wgmma kernels in the library's SASS: warpgroup products
        # (HGMMA), none of mma.sync's (HMMA)
        dump = subprocess.run([str(Path(_build.find_nvcc()).parent / "cuobjdump"), "-sass",
                               str(_build.build())], capture_output=True, text=True).stdout
        bodies, current = {}, None
        for line in dump.splitlines():
            m_ = re.match(r"\s*Function : (\S+)", line)
            if m_:
                current = next((k_ for k_ in head64_wgmma if k_ in m_.group(1)), None)
                if current is not None:
                    bodies[current] = []
            elif line.startswith("Fatbin"):
                current = None
            elif current is not None:
                bodies[current].append(line)
        for k_ in head64_wgmma:
            body = "\n".join(bodies.get(k_, []))
            n_hgmma, n_hmma = len(re.findall(r"\bHGMMA\.", body)), len(re.findall(r"\bHMMA\.", body))
            ph.check(n_hgmma > 0 and n_hmma == 0,
                     f"SASS of {k_}: {n_hgmma} HGMMA, {n_hmma} HMMA instructions")
        ph.check(sorted(seen768) == sorted(D768_KERNELS),
                 f"the layer chain's D 768 instances built, none spills: {len(seen768)} of "
                 f"{len(D768_KERNELS)} (the others share a D 192 instance: "
                 f"{sorted(set(D768_KERNELS) - set(seen768)) or 'none missing'})")
        ph.check(sorted(seen64) == sorted(D64_KERNELS),
                 f"the layer chain's D 64 instances built, none spills: {len(seen64)} of "
                 f"{len(D64_KERNELS)} (missing: "
                 f"{sorted(set(D64_KERNELS) - set(seen64)) or 'none'})")

    # ---- 2. kernels against their plain versions at hub shapes --------------
    valid_len = [1 + N_PATCHES * c for c in COUNTS]
    inputs = {}  # per dtype tag: the plain chain's intermediates, kept for phase 5
    with Phase("2 kernels vs plain", failures) as ph:
        vl = torch.tensor(valid_len, dtype=torch.int32, device=dev)
        # the attention's tail cotangent covers every row of the tiles it computes
        query_rows = [-(-n // fa.SEQ_BLOCK) * fa.SEQ_BLOCK for n in valid_len]

        def draw(seed):
            """The layer's input, weights and cotangents of one seed, and the
            attention's cotangent on every row of the 64-query tiles that hold
            a valid query."""
            rng = np.random.default_rng(seed)
            x, w, dy, dy_tail = draw_layer(rng, dev, B, S_PAD, D, FFN, valid_len)
            dout_tail = torch.from_numpy(rng.standard_normal((B, S_PAD, D))
                                         .astype(np.float32)).to(dev)
            for i, n in enumerate(query_rows):
                dout_tail[i, n:] = 0
            return x, w, dy, dy_tail, dout_tail

        notes = Bf16Notes(ph, stats)  # the worst bf16 readings over BF16_SEEDS

        for seed, tag, dt in ((0, "", torch.float32),
                              *((s_, "_bf16", bf16) for s_ in BF16_SEEDS)):
            x, w, dy, dy_tail, dout_tail = draw(seed)
            notes.where = f", seed {seed}"
            if dt == bf16:
                log(f"  bf16 instances, inputs of seed {seed}")
            f32 = dt == torch.float32
            xd, dyd = x.to(dt), dy.to(dt)

            def note(name, err, tol, what):
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
                ph.check(err <= tol, f"{name}{what}: max abs {err:.3e} (tolerance {tol:.3g})")

            def note_bf16(name, out, ref, what, rows=valid_len):
                notes.note(name, out, ref, what, rows)

            # the layer chain's steps, its save outputs, the layer forward and
            # backward (check_chain), on the plain chain's own intermediates
            inp = check_chain(ph, stats, note_bf16, xd, w, dyd, dy_tail.to(dt), valid_len, H,
                              f" (B {B}, S_pad {S_PAD}, seed {seed})")
            qkv, attn = inp["qkv"], inp["attn"]
            q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
            inp.update(q=q, k=k, v=v)
            if seed == 0:
                inputs[tag] = inp
            g1, b1 = inp["wd"][4:6]

            # the attention (K3) and its lse, then its backward (K4) on the
            # inputs the layer's backward chain gives it
            out = fa.prefix_flash_attention(q, k, v, vl, H)
            torch.cuda.synchronize()
            lse_err = max((inp["klse"][i, :, :n] - inp["rlse"][i, :, :n]).abs().max().item()
                          for i, n in enumerate(valid_len))
            if f32:
                note("prefix_attention_fwd", valid_rows_err(out, attn, valid_len)[0],
                     KERNEL_TOL, "")
                note("prefix_attention_fwd", lse_err, KERNEL_TOL, " save output lse")
                # the 64-query tiles wholly past valid_len: zeros, and lse 1e30
                ko, kl = fa.attention_forward(q, k, v, vl, H, with_lse=True)
                torch.cuda.synchronize()
                ph.check(all(not ko[i, n:].any().item() and (kl[i, :, n:] == 1e30).all().item()
                             for i, n in enumerate(query_rows)),
                         "prefix_attention_fwd: zeros and lse 1e30 on the "
                         f"{sum(S_PAD - n for n in query_rows) // fa.SEQ_BLOCK} 64-query tiles "
                         "past valid_len")
                del ko, kl
            else:
                ph.check(out.dtype == bf16, "prefix_attention_fwd_bf16 writes bfloat16")
                note_bf16("prefix_attention_fwd_bf16", out, attn, "")
                note_bf16("prefix_attention_fwd_bf16", inp["klse"].transpose(1, 2),
                          inp["rlse"].transpose(1, 2), " save output lse")
            del out
            kname = "prefix_attention_bwd" + tag
            for args, kwargs in inp["bwd_inputs"]["attention_bwd"]:
                got, again = (fa.prefix_attention_bwd(*args, **kwargs) for _ in range(2))
                torch.cuda.synchronize()
                ph.check(torch.equal(got, again)
                         and all(not got[i, n:].any().item() for i, n in enumerate(valid_len)),
                         f"{kname} ({tuple(got.shape)}): the same bits on a second call, rows "
                         f"past valid_len zero")
                ref = fa.prefix_flash_attention_backward_reference(*args, **kwargs)
                if f32:
                    mag = max(ref[i, :n].abs().max().item() for i, n in enumerate(valid_len))
                    note(kname, valid_rows_err(got, ref, valid_len)[0],
                         GRAD_REL * max(1.0, mag), f" (output scale {mag:.3g})")
                else:
                    ph.check(got.dtype == bf16, f"{kname} writes bfloat16")
                    note_bf16(kname, got, ref, f" ({tuple(got.shape)})")
                del got, again, ref

            t = qkv.clone().requires_grad_(True)
            out = fa.prefix_flash_attention(t[..., :D], t[..., D:2 * D], t[..., 2 * D:], vl, H)
            got = torch.autograd.grad(out, t, dout_tail.to(dt))[0]
            with torch.no_grad():
                o, lse = fa.attention_forward(q, k, v, vl, H, with_lse=True)
                ref = fa.prefix_flash_attention_backward_reference(q, k, v, o, lse,
                                                                   dout_tail.to(dt), vl, H)
            torch.cuda.synchronize()
            tail_zero = all(not got[i, n:].any().item() for i, n in enumerate(query_rows))
            if f32:
                err = valid_rows_err(got, ref, query_rows)[0]
                mag = max(ref[i, :n].abs().max().item() for i, n in enumerate(query_rows))
                ok, what = err <= GRAD_REL * max(1.0, mag), f"max abs {err:.3e}"
            else:
                err, tol, cos = notes.measure(got, ref, query_rows, "K4 tail")
                ok = err <= tol and cos >= BF16_COS
                what = f"max abs {err:.3e} (tolerance {tol:.3g}), cosine 1 - {1 - cos:.2e}"
            ph.check(ok and tail_zero,
                     f"K4 tail{tag}: a cotangent on every row of the 64-query tiles that hold a "
                     f"valid query; PrefixFlashAttention against the plain backward: {what}; "
                     f"zero on the zero-filled tiles: {tail_zero}")
            del t, out, got, o, lse, ref

            # K5/K6, the LayerNorm kernels, on every row of the layer input (the
            # function has no valid_len), with the attention output as the
            # residual; the backward from the forward's own stats
            for res, eps in ((None, EPS1), (None, 1e-6), (attn, EPS1), (attn, 1e-6)):
                what = f" ({'LN(x + r)' if res is not None else 'LN(x)'}, eps {eps:g})"
                y, mu, rstd = ln.ln_fwd(xd, res, g1, b1, eps)
                dxl, dgl, dbl = ln.ln_bwd(xd, res, g1, mu, rstd, dyd)
                again = ln.ln_bwd(xd, res, g1, mu, rstd, dyd)
                torch.cuda.synchronize()
                ry, rmu, rrstd = ln.ln_fwd_reference(xd, res, g1, b1, eps)
                rdx, rdg, rdb = ln.ln_bwd_reference(xd, res, g1, mu, rstd, dyd)
                ph.check(all(torch.equal(a_, b_) for a_, b_ in zip((dxl, dgl, dbl), again)),
                         f"ln_bwd{tag}{what}: the same bits on a second run")
                ph.check(y.dtype == dxl.dtype == dt and all(
                    t_.dtype == torch.float32 for t_ in (mu, rstd, dgl, dbl)),
                         f"ln_fwd{tag}/ln_bwd{tag}: y, dx {dt}; stats, dgamma, dbeta f32")
                if f32:
                    note("ln_fwd", max((a_ - b_).abs().max().item() for a_, b_ in
                                       ((y, ry), (mu, rmu), (rstd, rrstd))),
                         KERNEL_TOL, what + " y, mean, rstd")
                    for out_, ref_, part in ((dxl, rdx, "dx"), (dgl, rdg, "dgamma"),
                                             (dbl, rdb, "dbeta")):
                        mag = ref_.abs().max().item()
                        note("ln_bwd", (out_ - ref_).abs().max().item(),
                             GRAD_REL * max(1.0, mag), f"{what} {part} (output scale {mag:.3g})")
                else:
                    note_bf16("ln_fwd_bf16", y, ry, what + " y", None)
                    note_bf16("ln_fwd_bf16", torch.stack((mu, rstd), -1),
                              torch.stack((rmu, rrstd), -1), what + " mean, rstd", None)
                    for out_, ref_, part in ((dxl, rdx, "dx"), (dgl, rdg, "dgamma"),
                                             (dbl, rdb, "dbeta")):
                        note_bf16("ln_bwd_bf16", out_, ref_, f"{what} {part}", None)
                if res is None and eps == 1e-6:  # the final norm's site, timed in phase 5
                    inp["ln"] = dict(mu=mu, rstd=rstd)
                del y, mu, rstd, dxl, dgl, dbl, again, ry, rmu, rrstd, rdx, rdg, rdb
        log(f"  bf16 instances, worst readings over seeds {', '.join(map(str, BF16_SEEDS))}: "
            + notes.summary())

    # ---- 2b. the head-64 instances (ChAdaViT-B/16) against their plain versions
    inputs16 = {}  # per dtype tag: the inputs of seed 0, kept for phase 5
    with Phase("2b head-64 kernels vs plain (B/16)", failures) as ph:
        notes16 = Bf16Notes(ph, stats)

        def note16(name, out, ref, rows, what, f32, scale_tol=False):
            """A float32 instance: max abs on the rows within KERNEL_TOL (GRAD_REL
            of the output's largest entry when that is > 1 and scale_tol); a
            bfloat16 instance: bf16_err's bounds."""
            torch.cuda.synchronize()
            if f32:
                err = valid_rows_err(out, ref, rows)[0] if rows else (out - ref).abs().max().item()
                mag = (max(ref[i, :n].abs().max().item() for i, n in enumerate(rows)) if rows
                       else ref.abs().max().item())
                tol = GRAD_REL * max(1.0, mag) if scale_tol else KERNEL_TOL
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
                ph.check(err <= tol, f"{name}{what}: max abs {err:.3e} (tolerance {tol:.3g})")
                return
            notes16.note(name, out, ref, what, rows)

        vl = torch.tensor(valid_len, dtype=torch.int32, device=dev)
        query_rows = [-(-n // fa.SEQ_BLOCK) * fa.SEQ_BLOCK for n in valid_len]
        for seed, tag, dt in ((0, "", torch.float32),
                              *((s_, "_bf16", bf16) for s_ in BF16_SEEDS)):
            rng = np.random.default_rng(100 + seed)
            notes16.where = f", seed {seed}"

            def dev_randn(*shape, scale=1.0):
                return torch.from_numpy((rng.standard_normal(shape) * scale)
                                        .astype(np.float32)).to(dev)

            # q, k, v as the layer makes them: LN1 and the packed QKV
            # projection (plain), column slices of one (B, S, 3 D) qkv
            x = dev_randn(B, S_PAD, D16).to(dt)
            g, b_ = 1 + dev_randn(D16, scale=0.1), dev_randn(D16, scale=0.05)
            wqkv = dev_randn(3 * D16, D16, scale=D16 ** -0.5).to(dt)
            bqkv = dev_randn(3 * D16, scale=0.02).to(dt)
            qkv = fused_block.ln_linear_reference(x, g, b_, EPS1, wqkv, bqkv)
            q, k, v = qkv[..., :D16], qkv[..., D16:2 * D16], qkv[..., 2 * D16:]
            dy = dev_randn(B, S_PAD, D16)
            dout_tail = dev_randn(B, S_PAD, D16)
            for i, n in enumerate(valid_len):
                dy[i, n:] = 0
                dout_tail[i, query_rows[i]:] = 0
            dy, dout_tail = dy.to(dt), dout_tail.to(dt)
            fwd, bwd = (fa.instance(_launch.entry_point(n, dt), 64)
                        for n in ("prefix_attention_fwd", "prefix_attention_bwd"))
            if dt == bf16:
                log(f"  bf16 head-64 instances, inputs of seed {seed}")
            before = (_launch.LAUNCHES[fwd], _launch.LAUNCHES[bwd])
            out, lse = fa.attention_forward(q, k, v, vl, H16, with_lse=True)
            again, lse_again = fa.attention_forward(q, k, v, vl, H16, with_lse=True)
            bare, _ = fa.attention_forward(q, k, v, vl, H16, with_lse=False)
            torch.cuda.synchronize()
            ph.check(torch.equal(out, again) and torch.equal(lse, lse_again)
                     and torch.equal(out, bare) and out.dtype == dt,
                     f"{fwd} (B {B}, S_pad {S_PAD}, {H16} heads of 64, {out.dtype}): the same "
                     f"bits on a second call, and without the lse")
            ref, rlse = fa.prefix_flash_attention_reference(q, k, v, vl, H16, return_lse=True)
            f32 = dt == torch.float32
            note16(fwd, out, ref, valid_len, "", f32)
            note16(fwd, lse.transpose(1, 2), rlse.transpose(1, 2), valid_len,
                   " save output lse", f32)
            ph.check(all(not out[i, n:].any().item() and (lse[i, :, n:] == 1e30).all().item()
                         for i, n in enumerate(query_rows)),
                     f"{fwd}: zeros and lse 1e30 on the "
                     f"{sum(S_PAD - n for n in query_rows) // fa.SEQ_BLOCK} 64-query tiles past "
                     f"valid_len")
            del again, lse_again, bare, ref, rlse
            for what, dout, rows in ((" cotangent on the valid rows", dy, valid_len),
                                     (" tail cotangent (every row of the computed tiles)",
                                      dout_tail, query_rows)):
                got = fa.prefix_attention_bwd(q, k, v, out, lse, dout, vl, H16)
                again = fa.prefix_attention_bwd(q, k, v, out, lse, dout, vl, H16)
                torch.cuda.synchronize()
                ph.check(torch.equal(got, again) and got.dtype == dt,
                         f"{bwd}{what}: the same bits on a second call")
                gref = fa.prefix_flash_attention_backward_reference(q, k, v, out, lse, dout, vl,
                                                                    H16)
                note16(bwd, got, gref, rows, what, f32, scale_tol=True)
                ph.check(all(not got[i, n:].any().item() for i, n in enumerate(query_rows)),
                         f"{bwd}{what}: exact zeros on the zero-filled tiles")
                del got, again, gref
            ph.check((_launch.LAUNCHES[fwd], _launch.LAUNCHES[bwd]) == (before[0] + 3,
                                                                      before[1] + 4),
                     f"{fwd} and {bwd} counted under the head-64 instances' names")
            if seed == 0:
                inputs16[tag] = dict(q=q, k=k, v=v, out=out, lse=lse, dout=dy)
            # K5/K6 at D 768 (the unfused layer's LayerNorms under ln_impl=pallas)
            for res, eps in ((None, EPS1), (None, 1e-6), (out, EPS1)):
                lwhat = f" at D {D16} ({'LN(x + r)' if res is not None else 'LN(x)'}, eps {eps:g})"
                y, mu, rstd = ln.ln_fwd(x, res, g, b_, eps)
                dxl, dgl, dbl = ln.ln_bwd(x, res, g, mu, rstd, dy)
                again = ln.ln_bwd(x, res, g, mu, rstd, dy)
                torch.cuda.synchronize()
                ph.check(all(torch.equal(a_, b2) for a_, b2 in zip((dxl, dgl, dbl), again)),
                         f"ln_bwd{tag}{lwhat}: the same bits on a second run")
                ry, rmu, rrstd = ln.ln_fwd_reference(x, res, g, b_, eps)
                rdx, rdg, rdb = ln.ln_bwd_reference(x, res, g, mu, rstd, dy)
                if f32:
                    err = max((a_ - b2).abs().max().item()
                              for a_, b2 in ((y, ry), (mu, rmu), (rstd, rrstd)))
                    stats["ln_fwd"]["max_abs_err"] = max(stats["ln_fwd"]["max_abs_err"], err)
                    ph.check(err <= KERNEL_TOL, f"ln_fwd{lwhat} y, mean, rstd: max abs {err:.3e}")
                    for o_, r_, part in ((dxl, rdx, "dx"), (dgl, rdg, "dgamma"),
                                         (dbl, rdb, "dbeta")):
                        mag = r_.abs().max().item()
                        err = (o_ - r_).abs().max().item()
                        stats["ln_bwd"]["max_abs_err"] = max(stats["ln_bwd"]["max_abs_err"], err)
                        ph.check(err <= GRAD_REL * max(1.0, mag),
                                 f"ln_bwd{lwhat} {part}: max abs {err:.3e} (output scale "
                                 f"{mag:.3g})")
                else:
                    note16("ln_fwd_bf16", y, ry, None, lwhat + " y", False)
                    note16("ln_fwd_bf16", torch.stack((mu, rstd), -1),
                           torch.stack((rmu, rrstd), -1), None, lwhat + " mean, rstd", False)
                    for o_, r_, part in ((dxl, rdx, "dx"), (dgl, rdg, "dgamma"),
                                         (dbl, rdb, "dbeta")):
                        note16("ln_bwd_bf16", o_, r_, None, f"{lwhat} {part}", False)
                del y, mu, rstd, dxl, dgl, dbl, again, ry, rmu, rrstd, rdx, rdg, rdb
            del x, qkv, dout_tail
            torch.cuda.empty_cache()
        log("  bf16 head-64 instances and K5/K6 at D 768, worst readings over seeds "
            f"{', '.join(map(str, BF16_SEEDS))}: " + notes16.summary())

    # ---- 2c. the layer chain's D 768 instances (B/16 on the fused route) -------
    inputs768 = {}  # per dtype tag: the inputs of seed 0, kept for phase 5
    with Phase("2c D 768 chain kernels vs plain (B/16 fused route)", failures) as ph:
        notes768 = Bf16Notes(ph, stats)
        for seed, tag, dt, (s_pad, counts) in (
                (0, "", torch.float32, NARROW_F32), (0, "_bucket", torch.float32, BUCKET_F32_SEQ),
                *((s_, "_bf16", bf16, NARROW_BF16) for s_ in BF16_SEEDS)):
            notes768.where = f", seed {seed}"
            valid7 = [1 + N_PATCHES * c for c in counts]
            x, w, dy, dy_tail = draw_layer(np.random.default_rng(200 + seed), dev, len(counts),
                                           s_pad, D16, FFN, valid7)
            inp = check_chain(ph, stats, notes768.note, x.to(dt), w, dy.to(dt), dy_tail.to(dt),
                              valid7, H16, f" (B {len(counts)}, S_pad {s_pad}, channels "
                                           f"{counts}, seed {seed})")
            if dt == bf16:  # the bfloat16 K1b's LayerNorm against its order model
                check_bf16_d768_ln_order(ph, inp, f" (B {len(counts)}, S_pad {s_pad}, seed "
                                                  f"{seed})")
            if seed == 0 and tag != "_bucket":  # phase 5 times the narrow shapes
                inputs768[tag] = inp
            del inp, x, w, dy, dy_tail
            torch.cuda.empty_cache()
        # the float32 K1a and K1b bit for bit against their order models, on
        # the float32 narrow and bucket shapes drawn from each of the phase's
        # seeds
        for seed, (s_pad, counts) in ((s_, shape) for shape in (NARROW_F32, BUCKET_F32_SEQ)
                                      for s_ in BF16_SEEDS):
            valid7 = [1 + N_PATCHES * c for c in counts]
            x, w, _, _ = draw_layer(np.random.default_rng(200 + seed), dev, len(counts), s_pad,
                                    D16, FFN, valid7)
            check_f32_d768_bits(ph, x, w, valid7, H16, f" (B {len(counts)}, S_pad {s_pad}, "
                                                        f"channels {counts}, seed {seed})")
            del x, w
            torch.cuda.empty_cache()
        log("  bf16 D 768 instances, worst readings over seeds "
            f"{', '.join(map(str, BF16_SEEDS))}: " + notes768.summary())

    # ---- 2d. the smoke width: the chain's D 64 instances, the head-32 attention
    inputs64 = {}  # per dtype tag: the hub inputs of seed 0, kept for phase 5
    with Phase("2d D 64 chain kernels vs plain (smoke widths)", failures) as ph:
        notes64 = Bf16Notes(ph, stats)

        def note64(name, out, ref, rows, what, f32, scale_tol=False):
            """Phase 2b's reading: float32 within KERNEL_TOL (GRAD_REL of the
            output's largest entry with scale_tol), bfloat16 bf16_err's bounds."""
            torch.cuda.synchronize()
            if not f32:
                notes64.note(name, out, ref, what, rows)
                return
            err = valid_rows_err(out, ref, rows)[0]
            mag = max(ref[i, :n].abs().max().item() for i, n in enumerate(rows) if n)
            tol = GRAD_REL * max(1.0, mag) if scale_tol else KERNEL_TOL
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            ph.check(err <= tol, f"{name}{what}: max abs {err:.3e} (tolerance {tol:.3g})")

        def check_head32(inp, dt, what):
            """K3 and its lse on the layer's own q, k, v (column slices of the
            plain chain's qkv), K4 on the inputs the layer's backward gives it:
            each twice for the same bits, zeros and lse 1e30 on the 64-query
            tiles past valid_len, counted under the head-32 names."""
            f32 = dt == torch.float32
            qkv, vl_, valid_ = inp["qkv"], inp["vl"], inp["valid_len"]
            q, k, v = qkv[..., :D64], qkv[..., D64:2 * D64], qkv[..., 2 * D64:]
            query_rows = [min(-(-n // fa.SEQ_BLOCK) * fa.SEQ_BLOCK, qkv.shape[1])
                          for n in valid_]
            fwd, bwd = (fa.instance(_launch.entry_point(n, dt), D64 // H64)
                        for n in ("prefix_attention_fwd", "prefix_attention_bwd"))
            before = (_launch.LAUNCHES[fwd], _launch.LAUNCHES[bwd])
            out, lse = fa.attention_forward(q, k, v, vl_, H64, with_lse=True)
            again, lse_again = fa.attention_forward(q, k, v, vl_, H64, with_lse=True)
            torch.cuda.synchronize()
            ph.check(torch.equal(out, again) and torch.equal(lse, lse_again) and out.dtype == dt
                     and all(not out[i, n:].any().item() and (lse[i, :, n:] == 1e30).all().item()
                             for i, n in enumerate(query_rows)),
                     f"{fwd}{what}: the same bits on a second call, zeros and lse 1e30 on the "
                     f"64-query tiles past valid_len")
            ref, rlse = fa.prefix_flash_attention_reference(q, k, v, vl_, H64, return_lse=True)
            note64(fwd, out, ref, valid_, "", f32)
            note64(fwd, lse.transpose(1, 2), rlse.transpose(1, 2), valid_, " save output lse", f32)
            del again, lse_again, ref, rlse
            for args, kwargs in inp["bwd_inputs"]["attention_bwd"]:
                got, again = (fa.prefix_attention_bwd(*args, **kwargs) for _ in range(2))
                torch.cuda.synchronize()
                ph.check(torch.equal(got, again) and got.dtype == dt
                         and all(not got[i, n:].any().item() for i, n in enumerate(valid_)),
                         f"{bwd} ({tuple(got.shape)}){what}: the same bits on a second call, "
                         f"rows past valid_len zero")
                gref = fa.prefix_flash_attention_backward_reference(*args, **kwargs)
                note64(bwd, got, gref, valid_, f" ({tuple(got.shape)})", f32, scale_tol=True)
                del got, again, gref
            ph.check((_launch.LAUNCHES[fwd], _launch.LAUNCHES[bwd]) == (before[0] + 2,
                                                                      before[1] + 2),
                     f"{fwd} and {bwd} counted under the head-32 instances' names")

        for seed, tag, dt in ((0, "", torch.float32),
                              *((s_, "_bf16", bf16) for s_ in BF16_SEEDS)):
            notes64.where = f", seed {seed}"
            for label, (s_pad, valid64) in (("hub", D64_HUB), ("crop", D64_CROP)):
                x, w, dy, dy_tail = draw_layer(np.random.default_rng(300 + seed), dev,
                                               len(valid64), s_pad, D64, FFN, valid64)
                what = (f" (D {D64}, {label}: B {len(valid64)}, S_pad {s_pad}, valid_len "
                        f"{min(valid64)}-{max(valid64)}, seed {seed})")
                inp = check_chain(ph, stats, notes64.note, x.to(dt), w, dy.to(dt),
                                  dy_tail.to(dt), valid64, H64, what)
                check_head32(inp, dt, what)
                if seed == 0 and label == "hub":
                    inputs64[tag] = inp
                del inp, x, w, dy, dy_tail
                torch.cuda.empty_cache()
        log("  bf16 D 64 and head-32 instances, worst readings over seeds "
            f"{', '.join(map(str, BF16_SEEDS))}: " + notes64.summary())

    # ---- 3. the JAX fixtures --------------------------------------------------
    with Phase("3 JAX fixtures", failures) as ph:
        # ChAdaViT-moyen, then ChAdaViT-B/16 (its batches pad to 2048 rows: the
        # unfused route), then ChAdaViT-B/16 at 3 channels (640 rows: the layer
        # chain's D 768 instances), each in float32 and in bfloat16
        for label, cls_path, dino_path, dt, cos_bound, abs_bound, dino_bounds in (
                ("", FIXTURE, DINO_FIXTURE, torch.float32, FIXTURE_COS,
                 lambda ref: FIXTURE_TOL, (DINO_METRIC_REL, DINO_NORM_REL, DINO_DELTA_REL)),
                ("bf16, ", FIXTURE_BF16, DINO_FIXTURE_BF16, bf16, FIXTURE_BF16_COS,
                 lambda ref: FIXTURE_BF16_TOL,
                 (DINO_BF16_METRIC_REL, DINO_BF16_NORM_REL, DINO_BF16_DELTA_REL)),
                ("B/16, ", FIXTURE_B16, DINO_FIXTURE_B16, torch.float32, FIXTURE_COS,
                 lambda ref: FIXTURE_TOL, (DINO_METRIC_REL, DINO_NORM_REL, DINO_DELTA_REL)),
                ("B/16 bf16, ", FIXTURE_B16_BF16, DINO_FIXTURE_B16_BF16, bf16,
                 FIXTURE_B16_BF16_COS,
                 lambda ref: FIXTURE_B16_BF16_STEPS * bf16_step(ref.abs().max().item()),
                 (DINO_BF16_METRIC_REL, DINO_BF16_NORM_REL, DINO_BF16_DELTA_REL)),
                ("B/16 fused route, ", FIXTURE_B16_NARROW, DINO_FIXTURE_B16_NARROW,
                 torch.float32, FIXTURE_COS, lambda ref: FIXTURE_TOL,
                 (DINO_METRIC_REL, DINO_NORM_REL, DINO_DELTA_REL)),
                ("B/16 fused route bf16, ", FIXTURE_B16_NARROW_BF16, DINO_FIXTURE_B16_NARROW_BF16,
                 bf16, FIXTURE_B16_BF16_COS,
                 lambda ref: FIXTURE_B16_BF16_STEPS * bf16_step(ref.abs().max().item()),
                 (DINO_BF16_METRIC_REL, DINO_BF16_NORM_REL, DINO_BF16_DELTA_REL))):
            check_cls_fixture(ph, label, cls_path, dt, cos_bound, abs_bound)
            check_dino_fixture(ph, label, dino_path, dt, *dino_bounds)
            torch.cuda.empty_cache()

    # ---- 4. the served path -------------------------------------------------
    n_served, batch = 24, 8
    with Phase("4 served path", failures) as ph:
        model = hub.load_chadavit16_moyen(seed=0)  # device=None: the card
        counts = [1 + i % 10 for i in range(n_served)]
        images = hub.random_images(counts, 224, seed=2)
        reset_launches()
        t = time.perf_counter()
        emb = hub.extract_embeddings(model, images, batch_size=batch)
        served_s = time.perf_counter() - t
        launches = read_launches()
        layer_batches = len(model.blocks) * math.ceil(n_served / batch)
        expected = {name: 0 for name in instances}
        expected.update({"ln_linear_fwd": layer_batches, "prefix_attention_fwd": layer_batches,
                         "linear_relu_fwd": layer_batches,
                         "linear_residual_ln_fwd": 2 * layer_batches})
        ph.check(emb.shape == (n_served, D) and bool(np.isfinite(emb).all()),
                 f"embeddings {emb.shape}, all finite ({served_s:.2f} s for {n_served} images)")
        ph.check(launches == expected, f"launches {launches} == expected {expected}")
        with torch.inference_mode():
            plain = []
            for s in range(0, n_served, batch):
                xb, cb = hub.collate_images(images[s:s + batch])
                plain.append(plain_backbone(model, xb.to(dev), cb.to(dev)).cpu())
        plain = torch.cat(plain)
        cos = cosine_rows(torch.from_numpy(emb), plain)
        err = (torch.from_numpy(emb) - plain).abs().max().item()
        ph.check(cos.min().item() >= SERVED_COS,
                 f"kernels against plain versions on the card: min cosine "
                 f"1 - {1 - cos.min().item():.2e} (>= 1 - {1 - SERVED_COS:.0e}), max abs {err:.3e}")

        # the served path in bfloat16: the compute dtype, float32 parameters
        model_b = hub.load_chadavit16_moyen(seed=0, dtype=bf16)
        ph.check(all(t.dtype == torch.float32 for t in model_b.state_dict().values()),
                 "bf16 model: every parameter float32 on the card, LN scale/bias included")
        reset_launches()
        t = time.perf_counter()
        emb_b = hub.extract_embeddings(model_b, images, batch_size=batch)
        served_b_s = time.perf_counter() - t
        launches = read_launches()
        expected_b = {name: 0 for name in instances}
        expected_b.update({f"{name}_bf16": n for name, n in expected.items() if n})
        ph.check(emb_b.shape == (n_served, D) and emb_b.dtype == np.float32
                 and bool(np.isfinite(emb_b).all()),
                 f"bf16 embeddings {emb_b.shape} {emb_b.dtype}, all finite "
                 f"({served_b_s:.2f} s for {n_served} images)")
        ph.check(launches == expected_b, f"bf16 launches {launches} == expected {expected_b}")
        with torch.inference_mode():
            plain_b = []
            for s in range(0, n_served, batch):
                xb, cb = hub.collate_images(images[s:s + batch])
                plain_b.append(plain_backbone(model_b, xb.to(dev, bf16), cb.to(dev))
                               .float().cpu())
        plain_b = torch.cat(plain_b)
        cos = cosine_rows(torch.from_numpy(emb_b), plain_b)
        err = (torch.from_numpy(emb_b) - plain_b).abs().max().item()
        ph.check(cos.min().item() >= SERVED_BF16_COS,
                 f"bf16 kernels against plain bf16 versions on the card: min cosine "
                 f"1 - {1 - cos.min().item():.2e} (>= 1 - {1 - SERVED_BF16_COS:.0e}), "
                 f"max abs {err:.3e}; "
                 f"against the f32 embeddings: min cosine "
                 f"1 - {1 - cosine_rows(torch.from_numpy(emb_b), torch.from_numpy(emb)).min().item():.2e}")

    # ---- 4b. the train path ---------------------------------------------------
    with Phase("4b train path", failures) as ph:
        spec = DinoPretrainSpec()
        state, step, backbone, _ = build_dino(spec)  # device=None: the card
        train_batch = synthetic_dino_batch(spec, TRAIN_B, seed=4)
        tcounts = train_batch["channel_counts"].tolist()
        reset_launches()
        losses = []
        t = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state, m = step(state, train_batch)
            losses.append(float(m["dino_loss"]))
            if len(losses) == 1:
                after_step1 = {n: p.detach().clone() for n, p in state.trainable()}
                dirs_step1 = [b.clone() for b in state.opt_state.momentum]
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        launches = read_launches()
        runs = len(backbone.blocks) * TRAIN_STEPS  # layer runs of each model per path
        per_path = chain_launches(runs)
        expected = {name: 0 for name in instances}
        expected.update(per_path)
        for name in kernels:  # the slice's main path: what the JSON line reports
            stats[name]["launches"] = launches[name]
        ph.check(all(math.isfinite(v) for v in losses),
                 f"{TRAIN_STEPS} steps of B {TRAIN_B} (channels {tcounts}), depth "
                 f"{len(backbone.blocks)}: "
                 f"dino_loss {losses}, finite ({train_s:.2f} s)")
        ph.check(launches == expected, f"launches {launches} == expected {expected} "
                 f"({len(backbone.blocks)} layers x {TRAIN_STEPS} steps: teacher forward, "
                 "student forward "
                 "with the save outputs, student backward with its three recomputes)")

        # step 1 again, the same state, through a plain backbone
        pstate, pstep, _, _ = build_dino(spec, backbone_apply=plain_backbone)
        pstate, pm = pstep(pstate, train_batch)
        loss_rel = abs(float(pm["dino_loss"]) / losses[0] - 1)
        worst_cos = min(torch.nn.functional.cosine_similarity(
            after_step1[n].double().flatten(), p.detach().double().flatten(), 0).item()
            for n, p in pstate.trainable())
        ph.check(loss_rel <= TRAIN_LOSS_REL and worst_cos >= TRAIN_PARAM_COS,
                 f"step 1, kernels against the plain backbone: loss rel {loss_rel:.2e} "
                 f"(<= {TRAIN_LOSS_REL:g}), worst per-tensor cosine of the updated "
                 f"parameters 1 - {1 - worst_cos:.2e} (>= 1 - {1 - TRAIN_PARAM_COS:.0e})")
        check_updates(ph, "step 1", [n for n, _ in pstate.trainable()], dirs_step1,
                      pstate.opt_state.momentum, spec, TRAIN_UPDATE_COS)
        del pstate, pstep, after_step1, dirs_step1
        torch.cuda.empty_cache()
        check_layer_backward(ph, backbone, train_batch, torch.float32)

        # the bf16 train path, the canonical precision, at the canonical batch
        spec_b = DinoPretrainSpec(dtype=bf16)
        state_b, step_b, backbone_b, _ = build_dino(spec_b)  # device=None: the card
        ph.check(all(p.dtype == torch.float32 for _, p in state_b.trainable())
                 and all(t.dtype == torch.float32 for part in state_b.teacher.values()
                         for t in part.state_dict().values()),
                 "bf16 trainer: student and teacher parameters float32")
        train_batch_b = synthetic_dino_batch(spec_b, TRAIN_BF16_B, seed=4)
        tcounts_b = train_batch_b["channel_counts"].tolist()
        reset_launches()
        losses_b = []
        t = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state_b, m = step_b(state_b, train_batch_b)
            losses_b.append(float(m["dino_loss"]))
            if len(losses_b) == 1:
                dirs_step1 = [b.clone() for b in state_b.opt_state.momentum]
        torch.cuda.synchronize()
        train_b_s = time.perf_counter() - t
        launches = read_launches()
        expected_b = {name: 0 for name in instances}  # the same depth as the f32 path
        expected_b.update({f"{name}_bf16": n for name, n in per_path.items()})
        for name in kernels:
            stats[name + "_bf16"]["launches"] = launches[name + "_bf16"]
        ph.check(train_batch_b["crops"].dtype == bf16 and all(math.isfinite(v) for v in losses_b),
                 f"bf16: {TRAIN_STEPS} steps of B {TRAIN_BF16_B} x 2 global crops (channels "
                 f"{tcounts_b}), depth {len(backbone_b.blocks)}: dino_loss {losses_b}, finite "
                 f"({train_b_s:.2f} s)")
        ph.check(launches == expected_b, f"bf16 launches {launches} == expected {expected_b}")
        # the partial sums of linear_wgrad_bf16 at this batch (2 crops a
        # sequence, s_pad up to 2048), and of the float32 linear_wgrad at the
        # float32 train batch and at this one: a plan that does not grow with
        # the batch
        s_max = 2048
        for tag, dt, batches in (("_bf16", bf16, (2 * TRAIN_BF16_B,)),
                                 ("", torch.float32, (2 * TRAIN_B, 2 * TRAIN_BF16_B))):
            for seqs in batches:
                scratch = []
                for n, k in fused_block.WGRAD_BF16_TILES | fused_block.WGRAD_WGMMA_TILES:
                    if (n, k) in fused_block.WGRAD_WGMMA_TILES:  # D 768: the stream-K walk
                        tn, tk = (fused_block.WGRAD_WGMMA_TILES if dt == bf16 else
                                  fused_block.WGRAD_F32_STREAM_TILES)[(n, k)]
                        slots = fused_block.wgrad_stream_slots(n, k, dt)
                        scratch.append(f"({n}, {k}) {slots} stream-K slots "
                                       f"{slots * (tn * tk + tn) * 4 / 1e6:.2f} MB")
                        continue
                    splits = fused_block.wgrad_splits(seqs, s_max, n, k, dt)
                    scratch.append(f"({n}, {k}) {splits} splits "
                                   f"{splits * (n * k + n) * 4 / 1e6:.2f} MB")
                log(f"  linear_wgrad{tag} partial scratch per weight shape (N, K) at {seqs} "
                    f"sequences of {s_max} rows: " + ", ".join(scratch))
        splits = fused_block.layernorm_bwd_splits(seqs, s_max)
        log(f"  layernorm_bwd partial scratch at {seqs} sequences of {s_max} rows: {splits} splits "
            f"{splits * 2 * D * 4 / 1e6:.2f} MB (one partial per 32-row tile: "
            f"{seqs * s_max // fused_block.ROW_BLOCK * 2 * D * 4 / 1e6:.2f} MB)")

        # step 1 again, the same state, through the plain chains
        pstate, pstep, _, _ = build_dino(spec_b, backbone_apply=plain_chain_backbone)
        pstate, pm = pstep(pstate, train_batch_b)
        loss_rel = abs(float(pm["dino_loss"]) / losses_b[0] - 1)
        ph.check(loss_rel <= TRAIN_BF16_LOSS_REL,
                 f"bf16 step 1, kernels against the plain chains: loss rel {loss_rel:.2e} "
                 f"(<= {TRAIN_BF16_LOSS_REL:g})")
        check_updates(ph, "bf16 step 1", [n for n, _ in pstate.trainable()], dirs_step1,
                      pstate.opt_state.momentum, spec_b, TRAIN_BF16_UPDATE_COS)
        del pstate, pstep, dirs_step1
        torch.cuda.empty_cache()
        check_layer_backward(ph, backbone_b, train_batch_b, bf16)
        torch.cuda.empty_cache()

    # ---- 4c. the pretrain entry point ------------------------------------------
    with Phase("4c pretrain entry point", failures) as ph, \
            tempfile.TemporaryDirectory() as tmp:
        from chadavit_tpu_torch import main_pretrain
        from chadavit_tpu_torch.train import loop
        from chadavit_tpu_torch.utils.checkpoint import STATE_FILE

        # every step's device span: CUDA events around the step the loop builds
        spans = []
        real_build = loop.build_dino
        timed_build = span_recording(real_build, spans)

        cfg_a = entry_cfg([f"checkpoint.dir={tmp}/a"])
        ph.check(cfg_a.optimizer.batch_size == 32 and cfg_a.precision == "bf16"
                 and cfg_a.data.num_large_crops == 2,
                 f"canonical recipe: batch {cfg_a.optimizer.batch_size}, precision "
                 f"{cfg_a.precision}, {cfg_a.data.num_large_crops} global crops of "
                 f"{cfg_a['augmentations'][0]['crop_size']} px, lr {cfg_a.optimizer.lr:g}")
        loop.build_dino = timed_build
        try:
            reset_launches()
            t = time.perf_counter()
            # (a) through the command line a user types, as its argument list
            metrics_a = main_pretrain.main(
                ["--config-path", str(CANONICAL.parent), "--config-name", CANONICAL.name,
                 *ENTRY, f"checkpoint.dir={tmp}/a", f"max_steps={ENTRY_STEPS}"])
            torch.cuda.synchronize()
            entry_s = time.perf_counter() - t
            launches = read_launches()
        finally:
            loop.build_dino = real_build
        depth = 12
        runs = depth * ENTRY_STEPS
        expected = {name: 0 for name in instances}
        expected.update({f"{name}_bf16": n for name, n in {
            **chain_launches(runs), "ln_fwd": 2 * ENTRY_STEPS, "ln_bwd": ENTRY_STEPS}.items()})
        for name in ("ln_fwd_bf16", "ln_bwd_bf16"):
            stats[name]["launches"] = launches[name]
        logs_a = read_logs(f"{tmp}/a")
        ph.check(sorted(logs_a) == list(range(1, ENTRY_STEPS + 1))
                 and all(math.isfinite(logs_a[i]["dino_loss"]) for i in logs_a),
                 f"(a) python -m chadavit_tpu_torch.main_pretrain ... max_steps={ENTRY_STEPS}: "
                 f"dino_loss "
                 f"{[logs_a[i]['dino_loss'] for i in sorted(logs_a)]}, finite "
                 f"({entry_s:.2f} s with set-up)")
        ph.check(launches == expected, f"(a) launches {launches} == expected {expected} "
                 f"({depth} layers x {ENTRY_STEPS} steps x (teacher + student), the final "
                 "norm's ln_fwd twice and ln_bwd once a step)")

        # the host loader beside the step: wall time, device span, the wait
        steady = [i for i in sorted(logs_a) if i > 2]
        step_ms = 1e3 * logs_a[steady[-1]]["step_time_s"]
        wait_ms = 1e3 * logs_a[steady[-1]]["data_wait_s"]
        span_ms = [s_.elapsed_time(e_) for s_, e_ in spans]
        loader = loop.build_pretrain_loader(cfg_a, seed=5)
        it = iter(loader)
        next(it)  # the workers' first batch
        t = time.perf_counter()
        n_batches = min(4, len(loader) - 1)
        for _ in range(n_batches):
            next(it)
        loader_ms = 1e3 * (time.perf_counter() - t) / n_batches
        del it, loader
        log(f"  entry point, {cfg_a.precision}, B {cfg_a.optimizer.batch_size} x "
            f"{cfg_a.data.num_large_crops} crops of {cfg_a['augmentations'][0]['crop_size']} "
            f"px, {cfg_a.data.num_workers} loader "
            f"threads: host loader {loader_ms:.1f} ms per batch on its own; steps 3-{ENTRY_STEPS}"
            f": wall {step_ms:.1f} ms per step, waiting for the batch {wait_ms:.1f} ms "
            f"({100 * wait_ms / step_ms:.1f} % of the step, the card idle); device span of "
            f"each step {', '.join(f'{v:.1f}' for v in span_ms)} ms ({smi})")

        # (b) stop at step 2 with a step checkpoint; (c) auto-resume to step 4
        cfg_b = entry_cfg([f"checkpoint.dir={tmp}/b", f"checkpoint.step_frequency={ENTRY_STOP}"])
        loop.run_dino_pretrain(cfg_b, max_steps=ENTRY_STOP)
        metrics_c = loop.run_dino_pretrain(cfg_b, max_steps=ENTRY_STEPS - ENTRY_STOP)
        logs_c = read_logs(f"{tmp}/b")
        same_logs = all(logs_a[i][k] == logs_c[i][k] for i in range(ENTRY_STOP + 1,
                                                                    ENTRY_STEPS + 1)
                        for k in ENTRY_METRICS)
        state_a, state_c = (torch.load(final_ckpt(f"{tmp}/{d}") / STATE_FILE,
                                       weights_only=True) for d in ("a", "b"))
        diff = differing_entries(state_a, state_c)
        ph.check(sorted(logs_c) == list(range(1, ENTRY_STEPS + 1)) and same_logs
                 and metrics_c == metrics_a and state_c["step"] == ENTRY_STEPS and not diff,
                 f"(b) {ENTRY_STOP} steps + (c) auto-resume to step {ENTRY_STEPS}: metrics of "
                 f"steps {ENTRY_STOP + 1}-{ENTRY_STEPS} equal (a)'s bit for bit: {same_logs}; "
                 f"final train state (step {state_c['step']}) equal bit for bit: entries that "
                 f"differ {diff[:5]}")
        del state_a, state_c
        torch.cuda.empty_cache()

        # block_impl=xla, float32: every LayerNorm through ln_fwd / ln_bwd, step 1
        # against the same run with plain LayerNorms (ln_impl=xla)
        cfg_x = entry_cfg(ENTRY_XLA + [f"checkpoint.dir={tmp}/x"])
        reset_launches()
        loop.run_dino_pretrain(cfg_x, max_steps=ENTRY_XLA_STEPS)
        launches = read_launches()
        n = ENTRY_XLA_STEPS
        expected = {name: 0 for name in instances}
        expected.update({"prefix_attention_fwd": 2 * depth * n, "prefix_attention_bwd": depth * n,
                         "ln_fwd": 2 * (3 * depth + 1) * n, "ln_bwd": (3 * depth + 1) * n})
        for name in ("ln_fwd", "ln_bwd"):
            stats[name]["launches"] = launches[name]
        ph.check(launches == expected, f"block_impl=xla, f32, {n} steps: launches {launches} == "
                 f"expected {expected} (3 LayerNorms a layer and the final norm, teacher and "
                 "student; the attention kernels; the projections in torch.matmul)")
        cfg_y = entry_cfg(ENTRY_XLA + [f"checkpoint.dir={tmp}/y", "backbone.kwargs.ln_impl=xla"])
        loop.run_dino_pretrain(cfg_y, max_steps=1)
        logs_x, logs_y = read_logs(f"{tmp}/x"), read_logs(f"{tmp}/y")
        loss_rel = abs(logs_x[1]["dino_loss"] / logs_y[1]["dino_loss"] - 1)
        ph.check(loss_rel <= TRAIN_LOSS_REL and all(math.isfinite(logs_x[i]["dino_loss"])
                                                    for i in logs_x),
                 f"block_impl=xla step 1, LayerNorm kernels against plain LayerNorms: loss "
                 f"{logs_x[1]['dino_loss']:.6f} vs {logs_y[1]['dino_loss']:.6f}, rel "
                 f"{loss_rel:.2e} (<= {TRAIN_LOSS_REL:g}); step 2 loss "
                 f"{logs_x[n]['dino_loss']:.6f}")
        st_x, st_y = (torch.load(step_ckpt(f"{tmp}/{d}", 1) / STATE_FILE, weights_only=True)
                      for d in ("x", "y"))
        spec_x = loop.spec_from_cfg(cfg_x, 1)
        ph.check(st_x["trainable"] == st_y["trainable"],
                 "the two runs train the same tensors")
        check_updates(ph, "block_impl=xla step 1", st_x["trainable"],
                          st_x["opt_state"]["momentum"], st_y["opt_state"]["momentum"],
                          spec_x, TRAIN_UPDATE_COS)
        del st_x, st_y
        torch.cuda.empty_cache()

    # ---- 4d. on-device augmentation -------------------------------------------
    with Phase("4d on-device augmentation", failures) as ph, \
            tempfile.TemporaryDirectory() as tmp:
        from chadavit_tpu_torch import bench, main_pretrain
        from chadavit_tpu_torch.data import device_augment as da
        from chadavit_tpu_torch.data import native
        from chadavit_tpu_torch.data.disk_dataset import generate
        from chadavit_tpu_torch.train import loop
        from chadavit_tpu_torch.utils.checkpoint import STATE_FILE

        # (a) the multicrop on the card against the CPU, on the same draws
        aug_counts = [COUNTS[i % len(COUNTS)] for i in range(AUG_B)]
        rng = np.random.default_rng(7)
        raw = rng.integers(0, 256, (AUG_B, 10, 224, 224), dtype=np.uint8)
        for i, c in enumerate(aug_counts):
            raw[i, c:] = 0
        aug_images = torch.from_numpy(raw).to(dev)
        aug_cc = torch.tensor(aug_counts, dtype=torch.int32, device=dev)
        aug_fns = {}
        for dt in (torch.float32, bf16):
            fn = da.make_multicrop_fn(bench.ASYMMETRIC_AUGS, dtype=dt)  # device None: the card
            fn_cpu = da.make_multicrop_fn(bench.ASYMMETRIC_AUGS, dtype=dt, device="cpu")
            aug_fns[dt] = fn
            gen = torch.Generator(device=dev).manual_seed(11)
            draws = [pipe.draw(gen, AUG_B, 10, dev) for pipe in fn.pipelines]
            t = time.perf_counter()
            out = fn(aug_images, aug_cc, draws=draws)["crops"]
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t
            ref = fn_cpu(aug_images.cpu(), aug_cc.cpu(), draws=da.draws_to(draws, "cpu"))["crops"]
            applied = {op: int(sum(v[op]["apply"].sum().item() for v in draws if op in v))
                       for op in ("color_jitter", "grayscale", "gaussian_blur", "solarization",
                                  "horizontal_flip")}
            if dt == torch.float32:
                err = (out.cpu() - ref).abs().max().item()
                ok, what = err <= AUG_TOL, f"max abs {err:.3e} (<= {AUG_TOL:g})"
            else:
                err, bound, cos = bf16_err(out.cpu(), ref)
                ok = err <= bound and cos >= BF16_COS
                what = f"max abs {err:.3e} (<= {bound:.3e}), cosine 1 - {1 - cos:.2e}"
            pad_zero = all(not out[:, i, c:].any().item() for i, c in enumerate(aug_counts))
            ph.check(ok and pad_zero and tuple(out.shape) == (2, AUG_B, 10, 224, 224)
                     and out.dtype == dt,
                     f"multicrop {dt} on the card ({card_s * 1e3:.1f} ms, first call) against "
                     f"the CPU on the same draws, {tuple(out.shape)}: {what}; padded planes "
                     f"exactly zero: {pad_zero}; images each op applied to, over both views: "
                     f"{applied}")
            if dt == bf16:
                step1_draws, step1_crops = draws, out
            first, again = (fn(aug_images, aug_cc, generator=da.aug_generator(1, 5, dev))["crops"]
                            for _ in range(2))
            ph.check(torch.equal(first, again), f"multicrop {dt}: one seed twice, the same bits")
        del ref, first, again

        # (b) the fused step: raw batches in, the views drawn on the card
        spec_f = DinoPretrainSpec(dtype=bf16)
        fstate, fused, fbackbone, _ = build_dino(spec_f,
                                                 device_augmentations=bench.ASYMMETRIC_AUGS)
        reset_launches()
        losses_f = []
        for i in range(TRAIN_STEPS):
            fbatch = {"images": aug_images, "channel_counts": aug_cc}
            if i == 0:
                fbatch["draws"] = step1_draws
            else:
                fbatch["generator"] = da.aug_generator(1, i, dev)
            fstate, m = fused(fstate, fbatch)
            losses_f.append(float(m["dino_loss"]))
            if i == 0:
                dirs_step1 = [b.clone() for b in fstate.opt_state.momentum]
        torch.cuda.synchronize()
        launches = read_launches()
        runs = len(fbackbone.blocks) * TRAIN_STEPS
        expected = {name: 0 for name in instances}
        expected.update({f"{name}_bf16": n for name, n in chain_launches(runs).items()})
        ph.check(all(math.isfinite(v) for v in losses_f),
                 f"fused step (bf16, device_augmentations=ASYMMETRIC_AUGS), {TRAIN_STEPS} steps "
                 f"of B {AUG_B} raw uint8 images: dino_loss {losses_f}, finite")
        ph.check(launches == expected, f"fused step launches {launches} == expected {expected} "
                 f"({len(fbackbone.blocks)} layers x {TRAIN_STEPS} steps x (teacher + student))")
        pstate, pstep, _, _ = build_dino(spec_f)
        pstate, pm = pstep(pstate, {"crops": step1_crops, "channel_counts": aug_cc})
        loss_rel = abs(float(pm["dino_loss"]) / losses_f[0] - 1)
        ph.check(loss_rel <= TRAIN_BF16_LOSS_REL,
                 f"fused step 1 against the plain build_dino step fed (a)'s bf16 crops: loss "
                 f"rel {loss_rel:.2e} (<= {TRAIN_BF16_LOSS_REL:g})")
        check_updates(ph, "fused step 1 against the plain step on (a)'s crops",
                      [n for n, _ in pstate.trainable()], dirs_step1, pstate.opt_state.momentum,
                      spec_f, TRAIN_BF16_UPDATE_COS)
        del fstate, fused, pstate, pstep, dirs_step1, step1_crops
        torch.cuda.empty_cache()

        # (c) the entry point on dino_idr10k.yaml over the port's generated manifest
        root = f"{tmp}/idr"
        t = time.perf_counter()
        generate(root, IDR_IMAGES, num_classes=7, seed=5, workers=4, image_subdir="")
        log(f"  wrote {IDR_IMAGES} images with the port's generator in "
            f"{time.perf_counter() - t:.2f} s; decoder: {native.describe()}")

        def idr_cfg(extra):
            from chadavit_tpu_torch.cli import apply_overrides
            from chadavit_tpu_torch.config import load_yaml, parse_pretrain_cfg

            return parse_pretrain_cfg(apply_overrides(load_yaml(str(IDR10K)), [
                f"data.train_path={root}", f"data.val_path={root}", *IDR_ENTRY, *extra]))

        spans = []
        real_build = loop.build_dino
        timed_build = span_recording(real_build, spans)

        cfg_i = idr_cfg([f"checkpoint.dir={tmp}/i"])
        ph.check(cfg_i.get("device_augmentations") and cfg_i.precision == "bf16"
                 and cfg_i.optimizer.batch_size == 32 and cfg_i.get("bucket_by_channels"),
                 f"dino_idr10k.yaml: device_augmentations {cfg_i.get('device_augmentations')}, "
                 f"precision {cfg_i.precision}, batch {cfg_i.optimizer.batch_size}, "
                 f"bucket_by_channels {cfg_i.get('bucket_by_channels')}, dataset "
                 f"{cfg_i.data.dataset}, decode_threads {cfg_i.data.decode_threads}, "
                 f"cache_decoded {cfg_i.data.cache_decoded}")
        loop.build_dino = timed_build
        try:
            t = time.perf_counter()
            metrics_i = main_pretrain.main(["--config-path", str(IDR10K.parent), "--config-name",
                                IDR10K.name, f"data.train_path={root}", f"data.val_path={root}",
                                *IDR_ENTRY, f"checkpoint.dir={tmp}/i", f"max_steps={ENTRY_STEPS}"])
            torch.cuda.synchronize()
            idr_s = time.perf_counter() - t
        finally:
            loop.build_dino = real_build
        logs_i = read_logs(f"{tmp}/i")
        ph.check(sorted(logs_i) == list(range(1, ENTRY_STEPS + 1))
                 and all(math.isfinite(logs_i[k]["dino_loss"]) for k in logs_i),
                 f"(i) main_pretrain on dino_idr10k.yaml, {ENTRY_STEPS} steps: dino_loss "
                 f"{[logs_i[k]['dino_loss'] for k in sorted(logs_i)]}, finite ({idr_s:.2f} s "
                 "with set-up)")
        loader = loop.build_pretrain_loader(cfg_i, seed=5)
        it = iter(loader)
        next(it)
        t = time.perf_counter()
        n_batches = min(3, len(loader) - 1)
        for _ in range(n_batches):
            next(it)
        loader_ms = 1e3 * (time.perf_counter() - t) / n_batches
        del it, loader
        last = logs_i[ENTRY_STEPS]
        log(f"  dino_idr10k.yaml, bf16, B 32, decoder {native.describe()}: host loader "
            f"{loader_ms:.1f} ms per batch on its own (first epoch, planes decoded); steps "
            f"3-{ENTRY_STEPS}: wall {1e3 * last['step_time_s']:.1f} ms per step, data_wait_s "
            f"{last['data_wait_s']:.6f}; device span of each step (multicrop included) "
            f"{', '.join(f'{s_.elapsed_time(e_):.1f}' for s_, e_ in spans)} ms ({smi})")
        cfg_ii = idr_cfg([f"checkpoint.dir={tmp}/ii", f"checkpoint.step_frequency={ENTRY_STOP}"])
        loop.run_dino_pretrain(cfg_ii, max_steps=ENTRY_STOP)
        metrics_iii = loop.run_dino_pretrain(cfg_ii, max_steps=ENTRY_STEPS - ENTRY_STOP)
        logs_iii = read_logs(f"{tmp}/ii")
        same_logs = all(logs_i[k][key] == logs_iii[k][key]
                        for k in range(ENTRY_STOP + 1, ENTRY_STEPS + 1) for key in ENTRY_METRICS)
        state_i, state_iii = (torch.load(final_ckpt(f"{tmp}/{d}") / STATE_FILE, weights_only=True)
                              for d in ("i", "ii"))
        diff = differing_entries(state_i, state_iii)
        ph.check(sorted(logs_iii) == list(range(1, ENTRY_STEPS + 1)) and same_logs
                 and metrics_iii == metrics_i
                 and state_iii["step"] == ENTRY_STEPS and not diff,
                 f"(ii) {ENTRY_STOP} steps + (iii) auto-resume to step {ENTRY_STEPS}: metrics of "
                 f"steps {ENTRY_STOP + 1}-{ENTRY_STEPS} equal (i)'s bit for bit: {same_logs}; "
                 f"final train state equal bit for bit: entries that differ {diff[:5]}")
        del state_i, state_iii
        torch.cuda.empty_cache()

        # (d) the port's bench, 8 steps, with its disk phase
        lines = []
        t = time.perf_counter()
        bench.run(steps=BENCH_STEPS, repeats=2, disk=True, disk_root=f"{tmp}/bench_disk",
                  b16_steps=BENCH_B16_STEPS, emit=lines.append)
        rec = json.loads(lines[-1])
        log(f"  bench ({time.perf_counter() - t:.1f} s): {lines[-1]}")
        finite_pos = all(isinstance(rec.get(k), (int, float)) and math.isfinite(rec[k])
                         and rec[k] > 0 for k in ("value", "device_img_s_per_chip",
                                                  "disk_wall_img_s_per_chip",
                                                  "disk_decode_planes_per_s",
                                                  "b16_wall_img_s_per_chip",
                                                  "b16_device_img_s_per_chip"))
        ph.check(finite_pos and 0 < rec["mfu"] <= 1 and 0 < rec["device_busy_share"] <= 1
                 and 0 < rec["b16_device_mfu"] <= 1 and rec["b16_batch"] == B16_TRAIN_B
                 and rec["metric"] == "dino_pretrain_images_per_sec_per_chip"
                 and len(lines) == 4,
                 f"bench at {BENCH_STEPS} steps: {len(lines)} JSON lines, the last parses: value "
                 f"{rec.get('value')} img/s, device {rec.get('device_img_s_per_chip')} img/s, "
                 f"mfu {rec.get('mfu')}, busy share {rec.get('device_busy_share')}, multicrop "
                 f"{rec.get('aug_device_ms')} ms a step, disk {rec.get('disk_wall_img_s_per_chip')}"
                 f" img/s, decode {rec.get('disk_decode_planes_per_s')} planes/s, decoder "
                 f"{rec.get('decoder')}; B/16 at {BENCH_B16_STEPS} steps of "
                 f"{rec.get('b16_batch')}: wall {rec.get('b16_wall_img_s_per_chip')} img/s, "
                 f"device {rec.get('b16_device_img_s_per_chip')} img/s, mfu "
                 f"{rec.get('b16_device_mfu')}")
        torch.cuda.empty_cache()

    # ---- 4e. ChAdaViT-B/16 on both routes ---------------------------------------
    with Phase("4e ChAdaViT-B/16", failures) as ph, tempfile.TemporaryDirectory() as tmp:
        from chadavit_tpu_torch import main_pretrain

        hd64 = {tag: (fa.instance("prefix_attention_fwd" + tag, 64),
                      fa.instance("prefix_attention_bwd" + tag, 64)) for tag in ("", "_bf16")}

        def b16_expected(tag, fwd_n, bwd_n):
            out = {name: 0 for name in instances}
            out.update({hd64[tag][0]: fwd_n, hd64[tag][1]: bwd_n})
            return out

        # (a) served: the hub on 24 images in batches of 8, each batch padded
        # to 10 channels (S 2048), against the same model with the attention's
        # plain version; only the head-64 forward launches
        images16 = hub.random_images(B16_SERVED_COUNTS, 224, seed=8)
        n_batches = math.ceil(len(images16) / batch)
        emb16 = {}
        for tag, dt, bound in (("", torch.float32, SERVED_COS), ("_bf16", bf16, SERVED_BF16_COS)):
            model16 = chada_vit(embed_dim=D16, num_heads=H16, return_all_tokens=False, dtype=dt)
            model16.load_state_dict(random_state_dict(model16, 0))
            model16 = model16.to(dev).eval()
            reset_launches()
            t = time.perf_counter()
            emb16[tag] = hub.extract_embeddings(model16, images16, batch_size=batch)
            served16_s = time.perf_counter() - t
            launches = read_launches()
            want = b16_expected(tag, len(model16.blocks) * n_batches, 0)
            ph.check(emb16[tag].shape == (len(images16), D16)
                     and bool(np.isfinite(emb16[tag]).all()),
                     f"B/16{tag} served: embeddings {emb16[tag].shape}, finite ({served16_s:.2f} "
                     f"s for {len(images16)} images of channels {B16_SERVED_COUNTS[:8]}...)")
            ph.check(launches == want, f"B/16{tag} served launches {launches} == expected {want} "
                     f"({len(model16.blocks)} layers x {n_batches} batches of the head-64 forward)")
            with plain_attention(), torch.inference_mode():
                plain16 = hub.extract_embeddings(model16, images16, batch_size=batch)
            cos = cosine_rows(torch.from_numpy(emb16[tag]), torch.from_numpy(plain16))
            err = np.abs(emb16[tag] - plain16).max()
            ph.check(cos.min().item() >= bound,
                     f"B/16{tag} served, kernels against the plain attention on the card: min "
                     f"cosine 1 - {1 - cos.min().item():.2e} (>= 1 - {1 - bound:.0e}), max abs "
                     f"{err:.3e}")
            del model16, plain16
            torch.cuda.empty_cache()

        def d768_expected(tag, layer_runs):
            """The launches of ``layer_runs`` layer runs of a train path on
            the layer chain at D 768: the chain's _d768 instances and the
            attention's head-64 ones."""
            out = {name: 0 for name in instances}
            for name, n in chain_launches(layer_runs).items():
                out[fa.instance(name + tag, 64) if name.startswith("prefix_attention")
                    else fused_block.instance(name + tag, D16)] = n
            return out

        # the narrow widths: max_channels 3 in float32 and 7 in bfloat16, where
        # the JAX gate takes the fused layer; only the chain's D 768 forward
        # instances and the head-64 attention forward launch, and the
        # embeddings match the same model through the plain versions
        for tag, dt, bound in (("", torch.float32, SERVED_COS), ("_bf16", bf16, SERVED_BF16_COS)):
            maxc, counts7 = B16_NARROW_SERVED[tag]
            images7 = hub.random_images(counts7, 224, seed=11)
            model16 = chada_vit(embed_dim=D16, num_heads=H16, return_all_tokens=False, dtype=dt)
            model16.load_state_dict(random_state_dict(model16, 0))
            model16 = model16.to(dev).eval()
            reset_launches()
            t = time.perf_counter()
            emb7 = hub.extract_embeddings(model16, images7, batch_size=batch, max_channels=maxc)
            served7_s = time.perf_counter() - t
            launches = read_launches()
            runs7 = len(model16.blocks) * math.ceil(len(images7) / batch)
            want = {name: 0 for name in instances}
            want.update({fused_block.instance("ln_linear_fwd" + tag, D16): runs7,
                         fused_block.instance("linear_relu_fwd" + tag, D16): runs7,
                         fused_block.instance("linear_residual_ln_fwd" + tag, D16): 2 * runs7,
                         hd64[tag][0]: runs7})
            ph.check(emb7.shape == (len(images7), D16) and bool(np.isfinite(emb7).all())
                     and launches == want,
                     f"B/16{tag} served at max_channels {maxc} ({len(images7)} images of channels "
                     f"{counts7[:8]}..., {served7_s:.2f} s): embeddings {emb7.shape}, finite; "
                     f"launches {launches} == expected {want}")
            with torch.inference_mode():
                plain7 = []
                for s_ in range(0, len(images7), batch):
                    xb_, cb_ = hub.collate_images(images7[s_:s_ + batch], maxc)
                    plain7.append(plain_backbone(model16, xb_.to(dev, dt), cb_.to(dev))
                                  .float().cpu())
            cos = cosine_rows(torch.from_numpy(emb7), torch.cat(plain7))
            ph.check(cos.min().item() >= bound,
                     f"B/16{tag} served at max_channels {maxc}, the layer chain against the plain "
                     f"versions on the card: min cosine 1 - {1 - cos.min().item():.2e} (>= 1 - "
                     f"{1 - bound:.0e}), max abs "
                     f"{(torch.from_numpy(emb7) - torch.cat(plain7)).abs().max().item():.3e}")
            del model16, plain7
            torch.cuda.empty_cache()

        # (b) the train step at the root bench's B/16 spec, step 1 from the
        # seeded init against the same model with the attention's plain forward
        # and backward (plain_attention_function): the loss and each tensor's
        # update at 4b's bounds, in float32 at 2 images x 2 crops and in
        # bfloat16 at 8 (4b's bf16 bounds hold at the canonical 32 images: at 2
        # images the DINO loss magnifies bf16 noise of both sides past them,
        # ChAdaViT-moyen's plain chains too); then in bfloat16 at 2 images, each
        # side against the float32 plain step: the kernels' step no farther from
        # it than B16_F32_GAP times the plain bf16 step's distance
        def step1(spec, counts, plain=False, backbone_apply=None):
            """Step 1 from the seeded init on a synthetic batch of ``counts``:
            (loss, each tensor's update direction, the names, the launches)."""
            batch_ = synthetic_dino_batch(spec, len(counts), seed=6, channel_counts=counts)
            reset_launches()
            with plain_attention() if plain else contextlib.nullcontext():
                st, stp, _, _ = build_dino(spec, backbone_apply=backbone_apply)
                st, m_ = stp(st, batch_)
                loss_ = float(m_["dino_loss"])
            out = (loss_, [b_.clone() for b_ in st.opt_state.momentum],
                   [n for n, _ in st.trainable()], read_launches())
            del st, stp, batch_, m_
            torch.cuda.empty_cache()
            return out

        def update_cosines(dirs_a, dirs_b, names):
            """Per-tensor cosines of two runs' update directions, sorted (the
            tensors that neither run moves, the frozen prototypes, left out)."""
            cos = []
            for n, x, y in zip(names, dirs_a, dirs_b):
                x, y = x.double().flatten(), y.double().flatten()
                if x.any() or y.any():
                    cos.append((torch.nn.functional.cosine_similarity(x, y, 0).item(), n))
            return sorted(cos)

        for tag, dt, counts, loss_bound, cos_bound in (
                ("", torch.float32, B16_CHECK_COUNTS, TRAIN_LOSS_REL, TRAIN_UPDATE_COS),
                ("_bf16", bf16, B16_CHECK_COUNTS_BF16, TRAIN_BF16_LOSS_REL,
                 TRAIN_BF16_UPDATE_COS)):
            spec16 = bench.b16_spec(dt)
            t = time.perf_counter()
            loss16, dirs16, names16, launches = step1(spec16, counts)
            step16_s = time.perf_counter() - t
            want = b16_expected(tag, 2 * 12, 12)
            if tag == "":  # the float32 B/16 train path's launches
                for name in hd64[tag]:
                    stats[name]["launches"] = launches[name]
            ph.check(math.isfinite(loss16) and launches == want,
                     f"B/16{tag} step 1 of {len(counts)} images x 2 crops (channels {counts}), "
                     f"depth 12, 65 536 prototypes: dino_loss {loss16:.6f} ({step16_s:.2f} s "
                     f"with set-up); launches {launches} == expected {want}")
            ploss, pdirs, _, _ = step1(spec16, counts, plain=True)
            loss_rel = abs(ploss / loss16 - 1)
            ph.check(loss_rel <= loss_bound,
                     f"B/16{tag} step 1, kernels against the plain attention: loss rel "
                     f"{loss_rel:.2e} (<= {loss_bound:g})")
            check_updates(ph, f"B/16{tag} step 1", names16, dirs16, pdirs, spec16, cos_bound)
            del dirs16, pdirs

        spec_b, spec_f = bench.b16_spec(bf16), bench.b16_spec(torch.float32)
        lk, dk, names16, _ = step1(spec_b, B16_CHECK_COUNTS)
        lp, dp, _, _ = step1(spec_b, B16_CHECK_COUNTS, plain=True)
        lf, df, _, _ = step1(spec_f, B16_CHECK_COUNTS, plain=True)
        gap_k, gap_p = abs(lk / lf - 1), abs(lp / lf - 1)
        ck, cp = update_cosines(dk, df, names16), update_cosines(dp, df, names16)
        worst = (1 - ck[0][0], 1 - cp[0][0])
        median = (1 - ck[len(ck) // 2][0], 1 - cp[len(cp) // 2][0])
        ph.check(gap_k <= B16_F32_GAP * gap_p + TRAIN_BF16_LOSS_REL
                 and worst[0] <= B16_F32_GAP * worst[1] and median[0] <= B16_F32_GAP * median[1],
                 f"B/16_bf16 step 1 of {len(B16_CHECK_COUNTS)} images x 2 crops, each bf16 side "
                 f"against the float32 plain step: loss rel kernels {gap_k:.2e}, plain "
                 f"{gap_p:.2e} (kernels <= {B16_F32_GAP:g} x plain + {TRAIN_BF16_LOSS_REL:g}); "
                 f"update cosines, worst 1 - {worst[0]:.2e} ({ck[0][1]}) against 1 - "
                 f"{worst[1]:.2e} ({cp[0][1]}), median 1 - {median[0]:.2e} against 1 - "
                 f"{median[1]:.2e} (kernels <= {B16_F32_GAP:g} x plain); kernels against plain: "
                 f"loss rel {abs(lk / lp - 1):.2e}, worst update cosine 1 - "
                 f"{1 - update_cosines(dk, dp, names16)[0][0]:.2e}")
        del dk, dp, df

        # the narrow buckets, where the JAX gate takes the fused layer: step 1
        # through the layer chain's D 768 instances against the same model
        # through the plain chains (plain_chain_backbone), at 4b's bounds:
        # bfloat16 on a 7-channel bucket of 8 images, float32 on a 3-channel
        # bucket of 2; the chain's D 768 launches of the JSON line are these
        for tag, dt, (width, counts), loss_bound, cos_bound in (
                ("_bf16", bf16, B16_BUCKET_BF16, TRAIN_BF16_LOSS_REL, TRAIN_BF16_UPDATE_COS),
                ("", torch.float32, B16_BUCKET_F32, TRAIN_LOSS_REL, TRAIN_UPDATE_COS)):
            spec7 = dataclasses.replace(bench.b16_spec(dt), max_channels=width)
            assert fused_block.jax_layer_fused(padded_seq(width), D16, FFN, H16, dt)
            t = time.perf_counter()
            loss7, dirs7, names7, launches = step1(spec7, counts)
            step7_s = time.perf_counter() - t
            want = d768_expected(tag, 12)
            for name in CHAIN_ENTRIES:
                stats[fused_block.instance(name + tag, D16)]["launches"] = launches[
                    fused_block.instance(name + tag, D16)]
            ph.check(math.isfinite(loss7) and launches == want,
                     f"B/16{tag} step 1 on a {width}-channel bucket of {len(counts)} images x 2 "
                     f"crops (channels {counts}), depth 12, the layer chain: dino_loss "
                     f"{loss7:.6f} ({step7_s:.2f} s with set-up); launches {launches} == "
                     f"expected {want}")
            ploss, pdirs, _, _ = step1(spec7, counts, backbone_apply=plain_chain_backbone)
            loss_rel = abs(ploss / loss7 - 1)
            if dt == torch.float32:
                ph.check(loss_rel <= loss_bound,
                         f"B/16{tag} step 1 on a {width}-channel bucket, kernels against the plain "
                         f"chains: loss rel {loss_rel:.2e} (<= {loss_bound:g})")
            else:
                spec7f = dataclasses.replace(bench.b16_spec(torch.float32), max_channels=width)
                floss = step1(spec7f, counts, backbone_apply=plain_chain_backbone)[0]
                gap_k, gap_p = abs(loss7 / floss - 1), abs(ploss / floss - 1)
                ph.check(gap_k <= B16_FUSED_LOSS_F32,
                         f"B/16{tag} step 1 on a {width}-channel bucket against the float32 plain "
                         f"step: loss rel kernels {gap_k:.2e} (<= {B16_FUSED_LOSS_F32:g}), plain "
                         f"bf16 chains {gap_p:.2e}; kernels against the plain bf16 chains "
                         f"{loss_rel:.2e}")
                gaps = layer_gaps(spec7, spec7f, counts)
                ratios = [k_ / p_ for k_, p_ in gaps]
                ph.check(max(ratios) <= B16_LAYER_F32_RATIO,
                         f"B/16{tag} step 1's backbone forward on the {width}-channel bucket, "
                         f"each layer's distance to the float32 plain chain: kernels over the "
                         f"plain bf16 chains {min(ratios):.4f} to {max(ratios):.4f} (<= "
                         f"{B16_LAYER_F32_RATIO:g}); kernels {gaps[0][0]:.3e} after layer 0, "
                         f"{gaps[-1][0]:.3e} after layer {len(gaps) - 1}")
            check_updates(ph, f"B/16{tag} step 1 on a {width}-channel bucket", names7, dirs7,
                          pdirs, spec7, cos_bound)
            del dirs7, pdirs

        # then 3 steps of the root bench's B/16 batch: 16 raw uint8 images of 10
        # channels, the multicrop inside the step; K3 24 and K4 12 launches a step
        state16, fused16, backbone16, _ = build_dino(
            bench.b16_spec(), device_augmentations=bench.ASYMMETRIC_AUGS)
        rng = np.random.default_rng(9)
        raw16 = torch.from_numpy(rng.integers(0, 255, (B16_TRAIN_B, 10, 224, 224),
                                              dtype=np.uint8)).to(dev)
        cc16 = torch.full((B16_TRAIN_B,), 10, dtype=torch.int32, device=dev)
        reset_launches()
        losses16 = []
        t = time.perf_counter()
        for i in range(TRAIN_STEPS):
            state16, m = fused16(state16, {"images": raw16, "channel_counts": cc16,
                                           "generator": da.aug_generator(2, i, dev)})
            losses16.append(float(m["dino_loss"]))
        torch.cuda.synchronize()
        train16_s = time.perf_counter() - t
        launches = read_launches()
        depth16 = len(backbone16.blocks)
        want = b16_expected("_bf16", 2 * depth16 * TRAIN_STEPS, depth16 * TRAIN_STEPS)
        for name in hd64["_bf16"]:
            stats[name]["launches"] = launches[name]
        ph.check(all(math.isfinite(v) for v in losses16) and launches == want,
                 f"B/16 bf16, {TRAIN_STEPS} steps of {B16_TRAIN_B} raw images of 10 channels, "
                 f"the multicrop inside: dino_loss {losses16}, finite ({train16_s:.2f} s); "
                 f"launches {launches} == expected {want} ({2 * depth16} of the head-64 forward "
                 f"and {depth16} of its backward a step)")
        b16_step = (state16, fused16, raw16, cc16)  # profiled in phase 5

        # (c) the entry point on the B/16 pod YAML: one device, synthetic data,
        # its channel buckets as written; the launches each batch's width
        # implies, from the loader's own batch plan: the layer chain where the
        # JAX gate says fused, the unfused layer elsewhere, both among them
        from chadavit_tpu_torch.cli import apply_overrides
        from chadavit_tpu_torch.config import load_yaml, parse_pretrain_cfg
        from chadavit_tpu_torch.train import loop as train_loop

        cfg16 = parse_pretrain_cfg(apply_overrides(load_yaml(str(B16_YAML)), B16_ENTRY))
        loader16 = train_loop.build_pretrain_loader(cfg16, seed=train_loop.resolve_seed(cfg16))
        loader16.set_epoch(0)
        widths16 = [loader16._bucket_width(idxs)
                    for idxs in loader16._batches()[:B16_ENTRY_STEPS]]
        fused_steps = [fused_block.jax_layer_fused(padded_seq(w_), D16, FFN, H16, bf16)
                       for w_ in widths16]
        want = d768_expected("_bf16", 12 * sum(fused_steps))
        for name in hd64["_bf16"]:  # the unfused steps' attention
            want[name] += (2 if name.startswith("prefix_attention_fwd") else 1) * 12 * (
                len(fused_steps) - sum(fused_steps))
        del loader16
        reset_launches()
        t = time.perf_counter()
        main_pretrain.main(["--config-path", str(B16_YAML.parent), "--config-name",
                            B16_YAML.name, *B16_ENTRY, f"checkpoint.dir={tmp}/b16",
                            f"max_steps={B16_ENTRY_STEPS}"])
        torch.cuda.synchronize()
        entry16_s = time.perf_counter() - t
        launches = read_launches()
        logs16 = read_logs(f"{tmp}/b16")
        ph.check(sorted(logs16) == list(range(1, B16_ENTRY_STEPS + 1))
                 and all(math.isfinite(logs16[i]["dino_loss"]) for i in logs16)
                 and launches == want and any(fused_steps) and not all(fused_steps),
                 f"python -m chadavit_tpu_torch.main_pretrain ... {B16_YAML.name} "
                 f"{' '.join(B16_ENTRY)} max_steps={B16_ENTRY_STEPS}: batches of "
                 f"{widths16} channels (bucket_by_channels as written; the layer chain at "
                 f"{[w_ for w_, f_ in zip(widths16, fused_steps) if f_]}, the unfused layer at "
                 f"{[w_ for w_, f_ in zip(widths16, fused_steps) if not f_]}), dino_loss "
                 f"{[logs16[i]['dino_loss'] for i in sorted(logs16)]}, finite ({entry16_s:.2f} s "
                 f"with set-up); launches {launches} == expected {want}")
        log("  the pod YAML's launches by route: layer chain (D 768) " + ", ".join(
            f"{n} {launches[n]}" for n in launches if n.endswith("_d768") and launches[n])
            + "; attention (head 64, both routes) " + ", ".join(
                f"{n} {launches[n]}" for n in hd64["_bf16"]))
        torch.cuda.empty_cache()

    # ---- 4f. the smoke YAML through the port's entry point ------------------------
    with Phase("4f smoke YAML through the entry point", failures) as ph, \
            tempfile.TemporaryDirectory() as tmp:
        from chadavit_tpu_torch import main_pretrain
        from chadavit_tpu_torch.cli import apply_overrides
        from chadavit_tpu_torch.config import load_yaml, parse_pretrain_cfg
        from chadavit_tpu_torch.train import loop as train_loop
        from chadavit_tpu_torch.utils import checkpoint as port_checkpoint
        from tests import torch_port_loop_fixture as loop_fixture

        for name in smoke_instances:  # the main path of the smoke instances
            stats[name]["launches"] = 0
        argv = ["--config-path", str(SMOKE_YAML.parent), "--config-name", SMOKE_YAML.stem,
                *loop_fixture.OVERRIDES, f"max_steps={loop_fixture.STEPS}"]

        def smoke_launches(what, tag, launches, runs):
            """The run's launches: those of a train path of ``runs`` layer runs
            on the dtype's D 64 and head-32 instances, no other."""
            want = {n: 0 for n in instances}
            for name, n in chain_launches(runs).items():
                want[fa.instance(name + tag, 32) if name.startswith("prefix_attention")
                     else fused_block.instance(name + tag, D64)] = n
            mine = [n for n in smoke_instances if want[n]]
            log(f"  {what} launches: " + ", ".join(f"{n} {launches[n]}" for n in mine))
            ph.check(launches == want and all(launches[n] > 0 for n in mine),
                     f"{what}: every launch on the {len(mine)} D 64 and head-32 instances of "
                     f"its dtype, each above 0, none elsewhere: launches == expected "
                     f"({runs} layer runs: {loop_fixture.STEPS} steps x 2 layers, teacher "
                     f"forward, student forward and backward)")
            for n in mine:
                stats[n]["launches"] = launches[n]

        # (a) float32 from the JAX loop's initial state, held to its metrics
        init, want_metrics = loop_fixture.load()
        cfg = parse_pretrain_cfg(apply_overrides(load_yaml(str(SMOKE_YAML)),
                                                 list(loop_fixture.OVERRIDES)))
        seed = train_loop.resolve_seed(cfg)
        spec = train_loop.spec_from_cfg(cfg, len(train_loop.build_pretrain_loader(cfg, seed=seed)))
        state0, _, smoke_backbone, _ = build_dino(spec, seed=seed)
        depth = len(smoke_backbone.blocks)
        for side in (state0.student, state0.teacher):
            for part, module in side.items():
                module.load_state_dict({k: torch.from_numpy(v) for k, v in init[part].items()})
        port_checkpoint.save_state(f"{tmp}/init", state0)
        del state0, smoke_backbone
        reset_launches()
        t = time.perf_counter()
        main_pretrain.main([*argv, "checkpoint.enabled=true", f"checkpoint.dir={tmp}/f32",
                            f"resume_from_checkpoint={tmp}/init"])
        torch.cuda.synchronize()
        smoke_s = time.perf_counter() - t
        launches = read_launches()
        logs = read_logs(f"{tmp}/f32")
        steps = sorted(logs)
        rels = {k: max(abs(logs[st][k] - w_) / max(abs(w_), 1e-30)
                       for st, w_ in zip(steps, want_metrics[k].tolist()))
                for k in loop_fixture.METRICS}
        ph.check(steps == list(range(1, loop_fixture.STEPS + 1))
                 and max(rels.values()) <= SMOKE_METRIC_REL,
                 f"python -m chadavit_tpu_torch.main_pretrain --config-path scripts/smoke "
                 f"--config-name {SMOKE_YAML.stem} {' '.join(loop_fixture.OVERRIDES)} "
                 f"max_steps={loop_fixture.STEPS} (cuda, float32, from the JAX loop's initial "
                 f"state): dino_loss {[logs[st]['dino_loss'] for st in steps]}; each metric's "
                 f"largest relative distance from the JAX loop's "
                 + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
                 + f" (<= {SMOKE_METRIC_REL:g}) ({smoke_s:.2f} s with set-up)")
        smoke_launches("float32 run", "", launches, depth * loop_fixture.STEPS)

        # (b) bfloat16 from the port's seeded init: finite losses, and step 1
        # against the same state and batch through the plain chains
        first = {}
        real_build = train_loop.build_dino

        def recording_build(*args, **kwargs):
            first["build"] = (args, kwargs)
            state, step, model, head = real_build(*args, **kwargs)

            def recording_step(state, batch):
                if "batch" not in first:
                    first["batch"] = {k: v.clone() for k, v in batch.items()}
                state, metrics = step(state, batch)
                if "loss" not in first:
                    first["loss"] = float(metrics["dino_loss"])
                    first["dirs"] = [b.clone() for b in state.opt_state.momentum]
                return state, metrics
            return state, recording_step, model, head

        train_loop.build_dino = recording_build
        try:
            reset_launches()
            t = time.perf_counter()
            main_pretrain.main([*argv, "precision=bf16", "checkpoint.enabled=true",
                                f"checkpoint.dir={tmp}/bf16"])
            torch.cuda.synchronize()
            smoke_b_s = time.perf_counter() - t
            launches = read_launches()
        finally:
            train_loop.build_dino = real_build
        logs_b = read_logs(f"{tmp}/bf16")
        losses_b = [logs_b[st]["dino_loss"] for st in sorted(logs_b)]
        ph.check(first["batch"]["crops"].dtype == bf16 and sorted(logs_b) == steps
                 and all(math.isfinite(v) for v in losses_b),
                 f"the same with precision=bf16, from the port's seeded init: dino_loss "
                 f"{losses_b}, finite ({smoke_b_s:.2f} s with set-up)")
        smoke_launches("bfloat16 run", "_bf16", launches, depth * loop_fixture.STEPS)
        args_b, kwargs_b = first["build"]
        pstate, pstep, _, _ = real_build(*args_b, **{**kwargs_b,
                                                     "backbone_apply": plain_chain_backbone})
        pstate, pm = pstep(pstate, first["batch"])
        loss_rel = abs(float(pm["dino_loss"]) / first["loss"] - 1)
        ph.check(loss_rel <= TRAIN_BF16_LOSS_REL,
                 f"bf16 step 1 of the entry point, kernels against the plain chains: loss "
                 f"{first['loss']:.6f}, rel {loss_rel:.2e} (<= {TRAIN_BF16_LOSS_REL:g})")
        check_updates(ph, "bf16 step 1 of the entry point", [n for n, _ in pstate.trainable()],
                      first["dirs"], pstate.opt_state.momentum, args_b[0], TRAIN_BF16_UPDATE_COS)
        del pstate, pstep, first
        torch.cuda.empty_cache()

    # ---- 4g. the offline evaluation -------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("4g evaluation", failures) as ph:
            eval_phase(ph, tmp, smi, instances, reset_launches, read_launches)

        # ---- 4h. validation during pretraining, main_umap, main_attn ------------------
        with Phase("4h validation", failures) as ph:
            validation_phase(ph, tmp, smi, instances, reset_launches, read_launches)

    # ---- 5. times -------------------------------------------------------------
    with Phase("5 times", failures) as ph:
        rows = sum(valid_len)  # rows the kernels must compute
        m_all = B * S_PAD
        key_ok = (torch.arange(S_PAD, device=dev)[None, :] < vl[:, None])[:, None, None, :]
        saved = dict(_launch.LAUNCHES)  # timing launches do not count

        def site(kernel_fn, plain_fn, lib_fn, ops, nbytes):
            return kernel_fn, plain_fn, lib_fn, ops, nbytes

        def heads(t):
            return t.reshape(B, S_PAD, H, D // H).transpose(1, 2)

        plain_step = {"layernorm_bwd": fused_block.layernorm_bwd_reference,
                      "linear_dgrad": fused_block.linear_dgrad_reference,
                      "linear_wgrad": fused_block.linear_wgrad_reference,
                      "attention_bwd": fa.prefix_flash_attention_backward_reference}
        kernel_step = {"layernorm_bwd": fused_block.layernorm_bwd,
                       "linear_dgrad": fused_block.linear_dgrad,
                       "linear_wgrad": fused_block.linear_wgrad,
                       "attention_bwd": fa.prefix_attention_bwd}

        def fresh(kwargs):  # layernorm_bwd sums into dgb in place: a copy per call
            return {k: (v.clone() if k == "dgb" else v) for k, v in kwargs.items()}

        def ln_bwd_library(args, kwargs):  # the site-1 residual add is left out
            dy_, xin, mean, rstd, g = args[:5]
            g, d_ = g.to(dy_.dtype), dy_.shape[-1]
            args2 = (dy_.reshape(-1, d_), xin.reshape(-1, d_), [d_], mean.reshape(-1, 1),
                     rstd.reshape(-1, 1), g, g, [True, True, True])
            return lambda: torch.ops.aten.native_layer_norm_backward(*args2)

        def dgrad_library(args, kwargs):
            """(at the ReLU-mask site: the same function, the product then
            the mask of hid > 0; the earlier reading: the product alone)"""
            dy_, wmat = args[0], args[1]
            dyf = dy_.reshape(-1, dy_.shape[-1])
            res, hid_ = kwargs.get("residual"), kwargs.get("relu_of")
            if res is not None:
                return lambda: torch.addmm(res.reshape(-1, res.shape[-1]), dyf, wmat)
            if hid_ is not None:  # the mask read from hid in the call, as the kernel reads it
                hidf = hid_.reshape(-1, hid_.shape[-1])
                return (lambda: torch.mm(dyf, wmat).masked_fill_(hidf <= 0, 0.0),
                        lambda: torch.mm(dyf, wmat))
            return lambda: torch.mm(dyf, wmat)

        def wgrad_library(args, kwargs):
            """(the same function: LN1 with the site's parameters at the QKV
            site, then dW and db; the earlier reading: the product alone on
            the pre-LN x)"""
            dy_, xin = args[0], args[1]
            dyf, xf_ = dy_.reshape(-1, dy_.shape[-1]), xin.reshape(-1, xin.shape[-1])
            ln_ = kwargs.get("ln")
            if ln_ is None:
                return (lambda: (torch.mm(dyf.t(), xf_), dyf.sum(0)),
                        lambda: torch.mm(dyf.t(), xf_))
            g_, b_ = (t.to(xin.dtype) for t in ln_[2:])
            return (lambda: (torch.mm(dyf.t(), F.layer_norm(xf_, (xf_.shape[-1],), g_, b_, EPS1)),
                             dyf.sum(0)),
                    lambda: torch.mm(dyf.t(), xf_))

        def attention_bwd_library(args, kwargs):
            q_, k_, v_ = (heads(t.detach()).requires_grad_(True) for t in args[:3])
            do_ = heads(args[5])
            out = F.scaled_dot_product_attention(q_, k_, v_, attn_mask=key_ok)
            return lambda: torch.autograd.grad(out, (q_, k_, v_), do_, retain_graph=True)

        library_of = {"layernorm_bwd": ln_bwd_library, "linear_dgrad": dgrad_library,
                      "linear_wgrad": wgrad_library, "attention_bwd": attention_bwd_library}

        def library_device(iname):
            """The rows whose library call CUDA events time by the host's
            launch rate, or whose events exceed their library's at D 64: their
            library call also by the profiler's device time (K2a at every
            width, K5, K6, the bf16 K2b and K2c at D 64)."""
            return (iname.startswith(("layernorm_bwd", "ln_fwd", "ln_bwd"))
                    or iname in ("linear_wgrad_bf16_d64", "linear_dgrad_bf16_d64"))
        from torch.profiler import ProfilerActivity, profile

        prof_reps = 20

        def device_ms(fns, attempts=3, counts=None):
            """The profiler's device time of each kernel the calls ``fns``
            launch, per round of them (and in ``counts``, when given, each
            kernel's launches per round as the trace holds them). A trace
            without device events (one of 24 such traces in one run on an
            H100) or whose launches per round are not whole is taken again;
            the last with events is kept. In this process a trace can lose
            launches of a kernel (up to 8 of 20; with a warm-up step that the
            trace drops, three traces in a row came back empty; a fresh
            process lost none, scripts/profiler_counts.py) or hold whole
            launches a round at about half their time (12 of 96 traces in
            one run, the head-64 K3 among them: 0.0715 against 0.1443 ms
            after a head start), so read_device then takes the time after a
            head start. Empty where every trace was."""
            kept = None
            for _ in range(attempts):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(prof_reps):
                        for fn in fns:
                            fn()
                    torch.cuda.synchronize()
                events = [e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
                if events:
                    kept = events
                    if all(e.count % prof_reps == 0 for e in events):
                        break
            if kept is None:
                return {}
            if counts is not None:
                counts.update({e.key: e.count / prof_reps for e in kept})
            return {e.key: e.self_device_time_total / 1e3 / prof_reps for e in kept}

        def lost_launches(counts):
            """' lost launches' where a kernel's launches per round in a
            trace are not whole, else ''."""
            return " lost launches" if any(c != round(c) for c in counts.values()) else ""

        def head_start_ms(fns, iters=20):
            """CUDA events around ``iters`` rounds of the calls ``fns`` queued
            behind a 0.1 s spin of the card (torch.cuda._sleep), so that the
            host has queued every launch before the first runs: the device's
            time, without the host's launch rate. None where the spin ended
            before the host had queued them."""
            for fn in fns:
                fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(200_000_000)
            t = time.perf_counter()
            start.record()
            for _ in range(iters):
                for fn in fns:
                    fn()
            end.record()
            queued = time.perf_counter() - t
            torch.cuda.synchronize()
            if queued > 0.08:  # the spin did not cover the queueing
                log(f"    (head start too short: {queued * 1e3:.1f} ms to queue)")
                return None
            return start.elapsed_time(end) / iters

        def read_device(fns):
            """The device time of a round of the calls ``fns``: the profiler's
            where its trace holds whole launches a round and reads no less
            than two thirds of the time after a head start, else CUDA events
            after a head start, else None (the kernels line then says null).
            Returns (ms or None, where it came from, the head start's reading
            or None, the profiler's time of each kernel, each kernel's
            launches a round in the trace)."""
            counts = {}
            per_kernel = device_ms(fns, counts=counts)
            hs_ms = head_start_ms(fns)
            prof_ms = sum(per_kernel.values())
            if not per_kernel:
                why = "the traces were empty"
            elif lost_launches(counts):
                why = "the trace lost launches"
            elif hs_ms is not None and prof_ms < 2 / 3 * hs_ms:
                why = f"the profiler read {prof_ms:.4f} ms"
            else:
                return prof_ms, "profiler", hs_ms, per_kernel, counts
            if hs_ms is not None:
                return hs_ms, f"events after a head start: {why}", hs_ms, per_kernel, counts
            return None, f"not read: {why}, the head start too short", hs_ms, per_kernel, counts

        def fmt_ms(ms):
            return "not read" if ms is None else f"{ms:.4f} ms"

        def step_cost(name, args, kwargs, es, rows_, m_):
            """(operations, bytes) a backward GEMM or layernorm_bwd call must do
            on ``rows_`` computed rows of ``m_``; f32 stats, LN parameters and
            parameter gradients are 4 bytes."""
            if name == "layernorm_bwd":
                d_ = args[0].shape[-1]
                nres = kwargs.get("residual") is not None
                return 10 * rows_ * d_, (es * ((2 + nres) * rows_ * d_ + m_ * d_)
                                         + 4 * (2 * rows_ + 3 * d_))
            if name == "linear_dgrad":
                kk, nn_ = args[1].shape
                aux = kwargs.get("relu_of") is not None or kwargs.get("residual") is not None
                return 2 * rows_ * kk * nn_, es * (rows_ * kk + kk * nn_ + aux * rows_ * nn_
                                                   + m_ * nn_)
            nn_, kk = args[0].shape[-1], args[1].shape[-1]
            return (2 * rows_ * nn_ * kk + rows_ * nn_,
                    es * rows_ * (nn_ + kk) + 4 * (nn_ * kk + nn_))

        def chain_runs(inp, dt):
            """The layer chain's steps on an input set of phase 2 or 2c: for each
            entry point its sites of one layer (kernel, plain version, library
            call, operations and bytes on the computed rows) and their weights
            ((out, in) as in nn.Linear)."""
            es = 4 if dt == torch.float32 else 2
            x, x2, hid, attn, vl_ = (inp[n] for n in ("x", "x2", "hid", "attn", "vl"))
            bsz, s_pad, d = x.shape
            f = hid.shape[-1]
            rows_, m_ = sum(inp["valid_len"]), bsz * s_pad
            wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = inp["wd"]
            # the library calls take the LN parameters in the activation dtype
            gl1, bl1, gl2, bl2 = (t.to(dt) for t in (g1, b1, g2, b2))
            xf, x2f, hidf, attnf = (t.reshape(-1, t.shape[-1]) for t in (x, x2, hid, attn))
            runs = {
                "ln_linear_fwd": [site(
                    lambda: fused_block.ln_linear(x, g1, b1, EPS1, wqkv, bqkv, vl_),
                    lambda: fused_block.ln_linear_reference(x, g1, b1, EPS1, wqkv, bqkv),
                    lambda: torch.addmm(bqkv, F.layer_norm(xf, (d,), gl1, bl1, EPS1), wqkv.t()),
                    2 * rows_ * d * 3 * d,
                    es * (rows_ * d + 3 * d * d + 3 * d + m_ * 3 * d) + 4 * 2 * d)],
                "linear_relu_fwd": [site(
                    lambda: fused_block.linear_relu(x2, w1, b1f, vl_),
                    lambda: fused_block.linear_relu_reference(x2, w1, b1f),
                    lambda: torch.relu(torch.addmm(b1f, x2f, w1.t())),
                    2 * rows_ * d * f, es * (rows_ * d + f * d + f + m_ * f))],
                "linear_residual_ln_fwd": [site(  # both sites of a layer
                    lambda: fused_block.linear_residual_ln(attn, wout, bout, x, g1, b1, EPS1,
                                                           vl_),
                    lambda: fused_block.linear_residual_ln_reference(attn, wout, bout, x, g1,
                                                                     b1, EPS1),
                    lambda: F.layer_norm(torch.addmm(bout, attnf, wout.t()) + xf, (d,), gl1, bl1,
                                         EPS1),
                    2 * rows_ * d * d,
                    es * (2 * rows_ * d + d * d + d + m_ * d) + 4 * 2 * d), site(
                    lambda: fused_block.linear_residual_ln(hid, w2, b2f, x2, g2, b2, EPS2, vl_),
                    lambda: fused_block.linear_residual_ln_reference(hid, w2, b2f, x2, g2, b2,
                                                                     EPS2),
                    lambda: F.layer_norm(torch.addmm(b2f, hidf, w2.t()) + x2f, (d,), gl2, bl2,
                                         EPS2),
                    2 * rows_ * f * d,
                    es * (rows_ * f + rows_ * d + f * d + d + m_ * d) + 4 * 2 * d)],
            }
            weights = {"linear_residual_ln_fwd": [(d, d), (d, f)]}
            # the backward steps, every call of one layer's backward, on the
            # inputs recorded by check_chain
            for name in ("layernorm_bwd", "linear_dgrad", "linear_wgrad"):
                calls = inp["bwd_inputs"][name]
                runs[name] = [site(
                    (lambda a=a, kw=kw, n=name: kernel_step[n](*a, **fresh(kw))),
                    (lambda a=a, kw=kw, n=name: plain_step[n](*a, **fresh(kw))),
                    library_of[name](a, kw), *step_cost(name, a, kw, es, rows_, m_))
                    for a, kw in calls]
                weights[name] = [tuple(a[1].shape) if name == "linear_dgrad"
                                 else (a[0].shape[-1], a[1].shape[-1]) for a, _ in calls]
            return runs, weights

        def time_entry(iname, sites, peak, what, weights=None):
            """An entry point's sites of one layer on the card, kept in
            stats[iname]: CUDA events (kernel, plain, plain, kernel: two
            readings each, in turns), one library call (a pair: the call for
            the same function, then an earlier yardstick, printed beside it),
            the bound (the larger of the operations over the dtype's peak and
            the bytes over the memory rate, summed over the sites), and the
            device time (read_device): the profiler's time of every kernel the
            calls launch, with each kernel's launches per round in the trace,
            and CUDA events behind a spin of the card (head_start_ms), the
            device's time free of the host's launch rate, which is the row's
            device time where the trace lost launches; where there are
            several sites, each site also on its own."""
            ms = plain_ms = lib_ms = bound = ops_bound = bytes_bound = 0.0
            lib_fns, old_fns = [], []
            for i_site, (kernel_fn, plain_fn, lib_fn, ops, nbytes) in enumerate(sites):
                t1, p1, p2, t2 = (time_ms(fn) for fn in (kernel_fn, plain_fn, plain_fn,
                                                         kernel_fn))
                lib_old = old_fn = None
                if isinstance(lib_fn, tuple):
                    lib_fn, old_fn = lib_fn
                    lib_old = time_ms(old_fn)
                lib = time_ms(lib_fn)
                lib_fns.append(lib_fn)
                old_fns.append(lib_fn if old_fn is None else old_fn)
                t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
                if len(sites) > 1:
                    site_dev, site_source, site_hs, *_ = read_device([kernel_fn])
                    lib_site_dev = ""
                    if library_device(iname) and old_fn is not None:  # both by device time
                        new_dev, new_src, *_ = read_device([lib_fn])
                        old_dev, old_src, *_ = read_device([old_fn])
                        lib_site_dev = (f"; library device {fmt_ms(new_dev)} ({new_src}), the "
                                        f"product alone {fmt_ms(old_dev)} ({old_src})")
                    log(f"    {iname} site, weight {weights[i_site]}: kernel "
                        f"{(t1 + t2) / 2:.4f} ms, device {fmt_ms(site_dev)} ({site_source}), "
                        f"after a head start {fmt_ms(site_hs)}, library {lib:.4f} ms"
                        + (f" (the product alone {lib_old:.4f} ms)" if lib_old is not None else "")
                        + lib_site_dev + f", bound {max(t_ops, t_bytes):.4f} ms")
                ms += (t1 + t2) / 2
                plain_ms += (p1 + p2) / 2
                lib_ms += lib
                bound += max(t_ops, t_bytes)
                ops_bound += t_ops
                bytes_bound += t_bytes
            dev_ms, source, hs_ms, per_kernel, counts = read_device(
                [kernel_fn for kernel_fn, *_ in sites])
            stats[iname].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                                bound_by="operations" if ops_bound >= bytes_bound else "bytes",
                                device_ms=dev_ms, device_ms_source=source)
            lib_dev = ""
            if library_device(iname):  # events read the host's launch rate there
                lib_dev_ms, lib_source, *_ = read_device(lib_fns)
                stats[iname].update(library_device_ms=lib_dev_ms,
                                    library_device_ms_source=lib_source)
                lib_dev = f" (device {fmt_ms(lib_dev_ms)}, {lib_source}"
                if old_fns != lib_fns:  # and with the earlier reading at its sites
                    old_dev_ms, old_source, *_ = read_device(old_fns)
                    lib_dev += f"; with the product alone {fmt_ms(old_dev_ms)}, {old_source}"
                lib_dev += ")"
            share = "" if dev_ms is None else f"; {100 * bound / dev_ms:.1f} % of its bound"
            log(f"  {iname} ({what}, {len(sites)} site{'s' * (len(sites) > 1)} of a layer): "
                f"kernel {ms:.4f} ms, device {fmt_ms(dev_ms)} ({source}{share}), after a head "
                f"start {fmt_ms(hs_ms)}, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms"
                f"{lib_dev}, bound {bound:.4f} ms ({stats[iname]['bound_by']}); "
                + ", ".join(f"{k_[:60]} {v_:.4f} (x{counts[k_]:g} a round)" for k_, v_ in
                            sorted(per_kernel.items(), key=lambda kv: -kv[1])))

        for tag, dt in (("", torch.float32), ("_bf16", bf16)):
            f32 = dt == torch.float32
            es = 4 if f32 else 2  # bytes of an activation or weight element
            peak = PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS
            inp = inputs[tag]
            xd, q, k, v, dyd, w = (inp[n] for n in ("x", "q", "k", "v", "dy", "w"))
            wqkv, bqkv, wout, bout, g1, b1, g2, b2, w1, b1f, w2, b2f = inp["wd"]
            gl1, bl1, gl2, bl2 = (t.to(dt) for t in (g1, b1, g2, b2))
            x2d = xd.reshape(-1, D)
            qh, kh, vh = heads(q), heads(k), heads(v)
            runs, site_weights = chain_runs(inp, dt)
            runs["prefix_attention_fwd"] = [site(
                lambda: fa.prefix_flash_attention(q, k, v, vl, H),
                lambda: fa.prefix_flash_attention_reference(q, k, v, vl, H),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=key_ok),
                sum(4 * n * n * D for n in valid_len), es * (3 * rows * D + m_all * D))]
            runs["prefix_attention_bwd"] = [site(
                (lambda a=a, kw=kw: fa.prefix_attention_bwd(*a, **kw)),
                (lambda a=a, kw=kw: fa.prefix_flash_attention_backward_reference(*a, **kw)),
                attention_bwd_library(a, kw), sum(10 * n * n * D for n in valid_len),
                es * (5 * rows * D + 3 * m_all * D) + 4 * (2 * H * rows))
                for a, kw in inp["bwd_inputs"]["attention_bwd"]]
            # K5/K6 at the final norm's site (LN(x), eps 1e-6) on the hub rows;
            # the bound counts every row: ln_fwd and ln_bwd take no valid_len
            # (the JAX package's plain LayerNorm over all M rows), so they read
            # and write all of them
            mu_l, rstd_l = inp["ln"]["mu"], inp["ln"]["rstd"]
            dy2d = dyd.reshape(-1, D)
            runs["ln_fwd"] = [site(
                lambda: ln.ln_fwd(xd, None, g1, b1, 1e-6),
                lambda: ln.ln_fwd_reference(xd, None, g1, b1, 1e-6),
                lambda: F.layer_norm(x2d, (D,), gl1, bl1, 1e-6),
                8 * m_all * D, es * (2 * m_all * D + 2 * D) + 4 * 2 * m_all)]
            runs["ln_bwd"] = [site(
                lambda: ln.ln_bwd(xd, None, g1, mu_l, rstd_l, dyd),
                lambda: ln.ln_bwd_reference(xd, None, g1, mu_l, rstd_l, dyd),
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy2d, x2d, [D], mu_l.reshape(-1, 1), rstd_l.reshape(-1, 1), gl1, bl1,
                    [True, True, True]),
                12 * m_all * D, es * (3 * m_all * D + D) + 4 * (2 * m_all + 2 * D))]
            for name, sites in runs.items():
                time_entry(name + tag, sites, peak, f"B {B}, S_pad {S_PAD}, D {D}",
                           site_weights.get(name))
            layer_bound = sum(stats[n + tag]["bound_ms"] for n in (
                "ln_linear_fwd", "prefix_attention_fwd", "linear_relu_fwd",
                "linear_residual_ln_fwd"))

            # K5/K6 finish on the device faster than the host launches them, so
            # CUDA events read the launch rate and the profiler their kernels
            # (above), which read their 12.6 MB tensors back to back from the
            # 50 MB L2; ln_bwd once more with the L2 cold, as a caller that has
            # run other work between calls finds it: a 128 MB buffer written
            # before each call (its kernel not counted)
            flush = torch.empty(32 * 2 ** 20, device=dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(prof_reps):
                    flush.zero_()
                    ln.ln_bwd(xd, None, g1, mu_l, rstd_l, dyd)
                torch.cuda.synchronize()
            ln_cold = sum(e.self_device_time_total / 1e3 / prof_reps for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and any(k in e.key for k in ("ln_bwd_kernel", "ln_reduce_kernel")))
            del flush
            log(f"  ln_bwd{tag} device time per call with the L2 cold (profiler, {prof_reps} "
                f"calls): {ln_cold:.4f} ms; bound (every row) "
                f"{stats['ln_bwd' + tag]['bound_ms']:.4f} ms")
            # K3 and K4 repeat their bits: fixed-order sums, no atomics
            for name in ("prefix_attention_fwd", "prefix_attention_bwd"):
                for kernel_fn, *_ in runs[name]:
                    first, again = kernel_fn(), kernel_fn()
                    torch.cuda.synchronize()
                    ph.check(torch.equal(first, again),
                             f"{name + tag} ({tuple(first.shape)}): the same bits on a second call")

            layer_ms = time_ms(lambda: fused_block.fused_encoder_block(xd, vl, *w, H, EPS1, EPS2))
            layer_plain_ms = time_ms(
                lambda: fused_block.fused_encoder_block_reference(xd, vl, *w, H, EPS1, EPS2))

            def library_layer(x_, ws, nh=H, mask=key_ok):  # addmm / SDPA / layer_norm
                wqkv_, bqkv_, wout_, bout_, g1_, b1_, g2_, b2_, w1_, b1f_, w2_, b2f_ = ws
                b_, s_, d_ = x_.shape
                xf_ = x_.reshape(-1, d_)
                qkv_ = torch.addmm(bqkv_, F.layer_norm(xf_, (d_,), g1_, b1_, EPS1), wqkv_.t())
                qh_, kh_, vh_ = (t.reshape(b_, s_, nh, d_ // nh).transpose(1, 2)
                                 for t in qkv_.reshape(b_, s_, 3 * d_).split(d_, -1))
                a_ = F.scaled_dot_product_attention(qh_, kh_, vh_, attn_mask=mask)
                a_ = a_.transpose(1, 2).reshape(-1, d_)
                x2_ = F.layer_norm(torch.addmm(bout_, a_, wout_.t()) + xf_, (d_,), g1_, b1_, EPS1)
                h_ = torch.relu(torch.addmm(b1f_, x2_, w1_.t()))
                return F.layer_norm(torch.addmm(b2f_, h_, w2_.t()) + x2_, (d_,), g2_, b2_, EPS2)

            lib_ws = (wqkv, bqkv, wout, bout, gl1, bl1, gl2, bl2, w1, b1f, w2, b2f)
            layer_lib_ms = time_ms(lambda: library_layer(xd, lib_ws))
            log(f"  fused_encoder_block{tag} forward (B {B}, S_pad {S_PAD}): kernels "
                f"{layer_ms:.4f} ms, plain {layer_plain_ms:.4f} ms, library "
                f"{layer_lib_ms:.4f} ms, bound {layer_bound:.4f} ms (sum of its steps' bounds)")
            bwd_args = (dyd, xd, vl, inp["ra"], inp["rx2"], inp["rr2"], inp["rlse"], inp["rst"],
                        w, H, EPS1)
            layer_bwd_ms = time_ms(lambda: fused_block.layer_backward(fused_block.KERNEL_STEPS,
                                                                       *bwd_args))
            layer_bwd_plain_ms = time_ms(
                lambda: fused_block.fused_encoder_block_backward_reference(*bwd_args))
            # the library's backward of the same layer: autograd through the
            # addmm / SDPA / layer_norm chain, on one graph kept for the timing
            xl = xd.detach().clone().requires_grad_(True)
            wl = [t.detach().clone().requires_grad_(True) for t in lib_ws]
            yl = library_layer(xl, wl)
            layer_bwd_lib_ms = time_ms(lambda: torch.autograd.grad(
                yl, [xl, *wl], dyd.reshape(-1, D), retain_graph=True))
            del xl, wl, yl
            layer_bwd_bound = sum(stats[n + tag]["bound_ms"] for n in
                                  ("prefix_attention_bwd", "layernorm_bwd", "linear_dgrad",
                                   "linear_wgrad"))
            log(f"  fused_encoder_block{tag} backward (B {B}, S_pad {S_PAD}): kernels "
                f"{layer_bwd_ms:.4f} ms, plain {layer_bwd_plain_ms:.4f} ms, library "
                f"{layer_bwd_lib_ms:.4f} ms (autograd of the addmm/SDPA/layer_norm chain), "
                f"bound of its backward steps {layer_bwd_bound:.4f} ms (the three forward "
                f"recomputes not counted)")

            # the head-64 instances (ChAdaViT-B/16) at the hub shapes of phase 2b
            # (B 8, S_pad 2048, D 768, 12 heads), on its inputs of seed 0: CUDA
            # events (kernel, plain, plain, kernel), the library's SDPA with the
            # key mask, the bound, the profiler's device time; the same bits twice
            i16 = inputs16[tag]
            q16, k16, v16, o16, lse16, do16 = (i16[n] for n in ("q", "k", "v", "out", "lse",
                                                               "dout"))

            def heads16(t):
                return t.reshape(B, S_PAD, H16, D16 // H16).transpose(1, 2)

            qh16, kh16, vh16 = (heads16(t) for t in (q16, k16, v16))
            ql16 = qh16.detach().requires_grad_(True)
            kl16, vl16 = (t.detach().requires_grad_(True) for t in (kh16, vh16))
            sdpa16 = F.scaled_dot_product_attention(ql16, kl16, vl16, attn_mask=key_ok)
            runs16 = {
                "prefix_attention_fwd": site(
                    lambda: fa.prefix_flash_attention(q16, k16, v16, vl, H16),
                    lambda: fa.prefix_flash_attention_reference(q16, k16, v16, vl, H16),
                    lambda: F.scaled_dot_product_attention(qh16, kh16, vh16, attn_mask=key_ok),
                    sum(4 * n * n * D16 for n in valid_len), es * (3 * rows * D16 + m_all * D16)),
                "prefix_attention_bwd": site(
                    lambda: fa.prefix_attention_bwd(q16, k16, v16, o16, lse16, do16, vl, H16),
                    lambda: fa.prefix_flash_attention_backward_reference(
                        q16, k16, v16, o16, lse16, do16, vl, H16),
                    lambda: torch.autograd.grad(sdpa16, (ql16, kl16, vl16), heads16(do16),
                                                retain_graph=True),
                    # in float32 its five products run on the tensor cores in 3xTF32,
                    # three TF32 products a product (csrc/mma_tf32.cuh)
                    sum((30 if f32 else 10) * n * n * D16 for n in valid_len),
                    es * (5 * rows * D16 + 3 * m_all * D16) + 4 * (2 * H16 * rows))}
            for name, one in runs16.items():
                iname = fa.instance(name + tag, 64)
                tf32 = f32 and name == "prefix_attention_bwd"
                time_entry(iname, [one], PEAK_TF32_FLOPS if tf32 else peak,
                           f"B {B}, S_pad {S_PAD}, D {D16}, {H16} heads of 64")
                if tf32:
                    log(f"  {iname}: bound in 3xTF32 {stats[iname]['bound_ms']:.4f} ms; its "
                        "products at the float32 FMA peak "
                        f"{sum(10 * n * n * D16 for n in valid_len) / PEAK_F32_FLOPS * 1e3:.4f} ms")
                first, again = one[0](), one[0]()
                torch.cuda.synchronize()
                ph.check(torch.equal(first, again),
                         f"{iname} ({tuple(first.shape)}): the same bits on a second call")
                del first, again
            del ql16, kl16, vl16, sdpa16, runs16
            torch.cuda.empty_cache()

            # the layer chain's D 768 instances at 2c's narrow hub shapes, on
            # its inputs of seed 0
            i7 = inputs768[tag]
            runs7, weights7 = chain_runs(i7, dt)
            bsz7, s7 = i7["x"].shape[:2]
            for name, sites in runs7.items():
                time_entry(fused_block.instance(name + tag, D16), sites, peak,
                           f"B {bsz7}, S_pad {s7}, D {D16}", weights7.get(name))
            layer7_ms = time_ms(lambda: fused_block.fused_encoder_block(
                i7["x"], i7["vl"], *i7["w"], H16, EPS1, EPS2))
            layer7_plain = time_ms(lambda: fused_block.fused_encoder_block_reference(
                i7["x"], i7["vl"], *i7["w"], H16, EPS1, EPS2))
            steps7 = [fused_block.instance(n + tag, D16) for n in (
                "ln_linear_fwd", "linear_relu_fwd", "linear_residual_ln_fwd")]
            vl7 = i7["vl"]
            key_ok7 = (torch.arange(s7, device=dev)[None, :] < vl7[:, None])[:, None, None, :]
            wd7 = i7["wd"]
            lib_ws7 = (*wd7[:4], *(t.to(dt) for t in wd7[4:8]), *wd7[8:])
            layer7_lib = time_ms(lambda: library_layer(i7["x"], lib_ws7, H16, key_ok7))
            log(f"  fused_encoder_block{tag} at D {D16} forward (B {bsz7}, S_pad {s7}): kernels "
                f"{layer7_ms:.4f} ms, plain {layer7_plain:.4f} ms, library: its chain steps' "
                f"calls {sum(stats[n]['library_ms'] for n in steps7):.4f} ms, the addmm/SDPA/"
                f"layer_norm layer {layer7_lib:.4f} ms; bound of its chain steps "
                f"{sum(stats[n]['bound_ms'] for n in steps7):.4f} ms (the attention not counted)")
            del runs7, i7
            torch.cuda.empty_cache()

            # the smoke width's D 64 chain instances and head-32 attention at
            # 2d's hub shapes (B 8, S_pad 2048, D 64 in 2 heads), on its
            # inputs of seed 0; device times after a head start too
            i64 = inputs64[tag]
            runs64, weights64 = chain_runs(i64, dt)
            bsz64, s64 = i64["x"].shape[:2]
            vl64, valid64 = i64["vl"], i64["valid_len"]
            rows64, m64 = sum(valid64), bsz64 * s64
            key_ok64 = (torch.arange(s64, device=dev)[None, :] < vl64[:, None])[:, None, None, :]

            def heads64(t):
                return t.reshape(bsz64, s64, H64, D64 // H64).transpose(1, 2)

            q64, k64, v64 = (i64["qkv"][..., j * D64:(j + 1) * D64] for j in range(3))

            def sdpa_bwd64(args):  # the library's backward of the same attention
                qs_, ks_, vs_ = (heads64(t.detach()).requires_grad_(True) for t in args[:3])
                out_ = F.scaled_dot_product_attention(qs_, ks_, vs_, attn_mask=key_ok64)
                do_ = heads64(args[5])
                return lambda: torch.autograd.grad(out_, (qs_, ks_, vs_), do_, retain_graph=True)

            runs64["prefix_attention_fwd"] = [site(
                lambda: fa.prefix_flash_attention(q64, k64, v64, vl64, H64),
                lambda: fa.prefix_flash_attention_reference(q64, k64, v64, vl64, H64),
                lambda: F.scaled_dot_product_attention(heads64(q64), heads64(k64), heads64(v64),
                                                       attn_mask=key_ok64),
                sum(4 * n * n * D64 for n in valid64), es * (3 * rows64 * D64 + m64 * D64))]
            runs64["prefix_attention_bwd"] = [site(
                (lambda a=a, kw=kw: fa.prefix_attention_bwd(*a, **kw)),
                (lambda a=a, kw=kw: fa.prefix_flash_attention_backward_reference(*a, **kw)),
                sdpa_bwd64(a), sum(10 * n * n * D64 for n in valid64),
                es * (5 * rows64 * D64 + 3 * m64 * D64) + 4 * (2 * H64 * rows64))
                for a, kw in i64["bwd_inputs"]["attention_bwd"]]
            for name, sites in runs64.items():
                iname = (fa.instance(name + tag, D64 // H64) if name.startswith("prefix_attention")
                         else fused_block.instance(name + tag, D64))
                time_entry(iname, sites, peak, f"B {bsz64}, S_pad {s64}, D {D64}",
                           weights64.get(name))
            layer64_ms = time_ms(lambda: fused_block.fused_encoder_block(
                i64["x"], vl64, *i64["w"], H64, EPS1, EPS2))
            layer64_plain = time_ms(lambda: fused_block.fused_encoder_block_reference(
                i64["x"], vl64, *i64["w"], H64, EPS1, EPS2))
            wd64 = i64["wd"]
            lib_ws64 = (*wd64[:4], *(t.to(dt) for t in wd64[4:8]), *wd64[8:])
            layer64_lib = time_ms(lambda: library_layer(i64["x"], lib_ws64, H64, key_ok64))
            log(f"  fused_encoder_block{tag} at D {D64} forward (B {bsz64}, S_pad {s64}): "
                f"kernels {layer64_ms:.4f} ms, plain {layer64_plain:.4f} ms, the addmm/SDPA/"
                f"layer_norm layer {layer64_lib:.4f} ms")
            del runs64, i64
            torch.cuda.empty_cache()

        xb, cb = hub.collate_images(images[:batch])
        xb, cb = xb.to(dev), cb.to(dev)
        for served_model, tag in ((model, ""), (model_b, " bf16")):
            with torch.inference_mode():
                served_model(xb, cb)
                torch.cuda.synchronize()
                t = time.perf_counter()
                reps = 5
                for _ in range(reps):
                    served_model(xb, cb)
                torch.cuda.synchronize()
                per_batch = (time.perf_counter() - t) / reps
            log(f"  served batch{tag} of {batch} images (channels {counts[:batch]}), depth 12: "
                f"{per_batch * 1e3:.2f} ms, {batch / per_batch:.1f} embeddings/s")

        from torch.profiler import ProfilerActivity, profile

        for tag, st, stp, tb, nb, tc, top in (("", state, step, train_batch, TRAIN_B, tcounts, 20),
                                              (" bf16", state_b, step_b, train_batch_b,
                                               TRAIN_BF16_B, tcounts_b, 24)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            reps = 3
            for _ in range(reps):
                st, m = stp(st, tb)
            float(m["dino_loss"])
            torch.cuda.synchronize()
            per_step = (time.perf_counter() - t) / reps
            log(f"  DINO train step{tag}, B {nb} images x 2 global crops (channels {tc}), "
                f"depth 12: {per_step * 1e3:.2f} ms, {nb / per_step:.2f} training images/s "
                f"({smi})")
            # one more step under the profiler: device time by kernel, and the
            # share of the step's wall time the device was busy (the profiler's
            # own cost is in the wall time, so the busy share reads low)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                st, m = stp(st, tb)
                float(m["dino_loss"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            # kernels only: an autograd Function's range also carries the device
            # time of the kernels launched inside it
            events = [e for e in prof.key_averages() if e.self_device_time_total > 0
                      and e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in events) / 1e3
            log(f"  profiled train step{tag}: wall {wall * 1e3:.2f} ms, device busy "
                f"{busy:.2f} ms ({100 * busy / (wall * 1e3):.1f} %), {len(events)} kernel "
                f"names; by device time:")
            ranked = sorted(events, key=lambda e: -e.self_device_time_total)
            # the top kernels, and K1a's, K1b's and the two passes of K2a and
            # K2c wherever they rank
            for rank, e in enumerate(ranked):
                if rank < top or any(k in e.key for k in (
                        "ln_linear", "linear_residual_ln", "layernorm_bwd", "reduce_ln_splits",
                        "linear_wgrad", "reduce_wgrad_splits", "reduce_wgrad_stream")):
                    ms = e.self_device_time_total / 1e3
                    log(f"    {ms:9.3f} ms {100 * ms / busy:5.1f} % x{e.count:<5d} "
                        f"#{rank + 1:<3d} {e.key[:90]}")
        # the multicrop of the bf16 fused step at B 32 (4d's raw batch), its
        # kernels by the profiler, beside the bf16 step's device time above
        reps = 10
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                aug_fns[bf16](aug_images, aug_cc, generator=da.aug_generator(1, i, dev))
            torch.cuda.synchronize()
        aug_ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps
        log(f"  multicrop bf16 (ASYMMETRIC_AUGS, 2 views of B {AUG_B} x 10 planes of 224 px, "
            f"channels {aug_counts[:10]}...): device {aug_ms:.3f} ms per step (profiler, {reps} "
            f"calls), {100 * aug_ms / busy:.1f} % of the profiled bf16 step's {busy:.2f} ms "
            f"({smi})")
        # the B/16 bf16 step (4e's batch of 16 raw images of 10 channels, the
        # multicrop inside): where its device time goes, the attention kernels
        # against the library's GEMMs and the rest; then the same step with
        # ln_impl=pallas (the unfused layer's LayerNorms through K5/K6)
        state16, fused16, raw16, cc16 = b16_step
        spec_ln = bench.b16_spec()
        spec_ln.backbone_kwargs = dict(spec_ln.backbone_kwargs, ln_impl="pallas")
        state_ln, fused_ln, _, _ = build_dino(spec_ln, device_augmentations=bench.ASYMMETRIC_AUGS)
        # and the same step on a 7-channel bucket (raw images of 7 planes),
        # where the layers take the layer chain's D 768 instances
        raw7 = raw16[:, :7].contiguous()
        cc7 = torch.full_like(cc16, 7)
        for what, st16, fn16, raw_, cc_ in (
                ("", state16, fused16, raw16, cc16),
                (" with ln_impl=pallas", state_ln, fused_ln, raw16, cc16),
                (" on a 7-channel bucket (the layer chain)", state16, fused16, raw7, cc7)):
            batch16 = {"images": raw_, "channel_counts": cc_,
                       "generator": da.aug_generator(2, 99, dev)}
            st16, _ = fn16(st16, dict(batch16))  # a step that warms the allocator
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                st16, m = fn16(st16, batch16)
                float(m["dino_loss"])
                torch.cuda.synchronize()
                wall16 = time.perf_counter() - t
            # kernels only: the multicrop's range has a device-side record of its own
            events16 = [e for e in prof.key_averages() if e.self_device_time_total > 0
                        and e.device_type == torch.autograd.DeviceType.CUDA
                        and e.key != bench.AUG_RANGE]
            busy16 = sum(e.self_device_time_total for e in events16) / 1e3
            attn16 = sum(e.self_device_time_total for e in events16
                         if "attention" in e.key) / 1e3
            gemm16 = sum(e.self_device_time_total for e in events16
                         if "attention" not in e.key
                         and any(k_ in e.key.lower() for k_ in ("gemm", "cutlass", "sm90_xmma",
                                                                 "ampere", "nvjet"))) / 1e3
            useful = bench.model_flops_per_image(int(cc_[0]), d=D16, f=FFN) * B16_TRAIN_B
            chain16 = sum(e.self_device_time_total for e in events16
                          if any(k_ in e.key for k_ in CHAIN_KERNEL_KEYS)) / 1e3
            log(f"  profiled B/16 bf16 step{what}, {B16_TRAIN_B} raw images of {int(cc_[0])} "
                f"channels, the layer chain's kernels {chain16:.2f} ms, the "
                f"multicrop inside: wall {wall16 * 1e3:.2f} ms, device busy {busy16:.2f} ms "
                f"({100 * busy16 / (wall16 * 1e3):.1f} %), useful {useful / 1e12:.2f} TFLOP "
                f"({useful / (busy16 * 1e-3) / PEAK_BF16_FLOPS:.4f} of 989 TFLOP/s on the device "
                f"time); the attention kernels {attn16:.2f} ms ({100 * attn16 / busy16:.1f} %), "
                f"the library's GEMMs {gemm16:.2f} ms ({100 * gemm16 / busy16:.1f} %), the rest "
                f"{busy16 - attn16 - gemm16 - chain16:.2f} ms ({smi}); by device time:")
            for rank, e in enumerate(sorted(events16, key=lambda e: -e.self_device_time_total)
                                     [:16]):
                ms = e.self_device_time_total / 1e3
                log(f"    {ms:9.3f} ms {100 * ms / busy16:5.1f} % x{e.count:<5d} #{rank + 1:<3d} "
                    f"{e.key[:90]}")
        del state_ln, fused_ln, st16, fn16
        del b16_step, state16, fused16
        # the float32 B/16 step 1 on 4e (b)'s 3-channel bucket (the layer
        # chain's D 768 instances): its device time and the chain's share
        width, counts = B16_BUCKET_F32
        spec3 = dataclasses.replace(bench.b16_spec(torch.float32), max_channels=width)
        st3, step3, _, _ = build_dino(spec3)
        batch3 = synthetic_dino_batch(spec3, len(counts), seed=6, channel_counts=counts)
        st3, _ = step3(st3, dict(batch3))  # a step that warms the allocator
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            st3, m = step3(st3, dict(batch3))
            float(m["dino_loss"])
            torch.cuda.synchronize()
            wall3 = time.perf_counter() - t
        events3 = [e for e in prof.key_averages() if e.self_device_time_total > 0
                   and e.device_type == torch.autograd.DeviceType.CUDA]
        if not events3:  # the profiler in this long process can come back empty
            log(f"  profiled B/16 f32 step 1 on a {width}-channel bucket: wall "
                f"{wall3 * 1e3:.2f} ms, the profiler's trace was empty")
        else:
            busy3 = sum(e.self_device_time_total for e in events3) / 1e3
            k1ab3 = sum(e.self_device_time_total for e in events3
                        if any(k_ in e.key for k_ in ("gemm128", "ln_rows_f32", "res_ln_rows")))
            chain3 = sum(e.self_device_time_total for e in events3
                         if any(k_ in e.key for k_ in CHAIN_KERNEL_KEYS)) / 1e3
            attn3 = sum(e.self_device_time_total for e in events3 if "attention" in e.key) / 1e3
            log(f"  profiled B/16 f32 step 1 on a {width}-channel bucket of {len(counts)} "
                f"images x 2 crops (channels {counts}), the layer chain: wall "
                f"{wall3 * 1e3:.2f} ms, device busy {busy3:.2f} ms "
                f"({100 * busy3 / (wall3 * 1e3):.1f} %); the layer chain's kernels "
                f"{chain3:.2f} ms ({100 * chain3 / busy3:.1f} %), of them K1a and K1b "
                f"{k1ab3 / 1e3:.2f} ms, the attention kernels {attn3:.2f} ms "
                f"({100 * attn3 / busy3:.1f} %), the rest {busy3 - chain3 - attn3:.2f} ms ({smi}); "
                "by device time:")
            for rank, e in enumerate(sorted(events3,
                                            key=lambda e: -e.self_device_time_total)[:12]):
                ms = e.self_device_time_total / 1e3
                log(f"    {ms:9.3f} ms {100 * ms / busy3:5.1f} % x{e.count:<5d} #{rank + 1:<3d} "
                    f"{e.key[:90]}")
        del st3, step3, batch3
        _launch.LAUNCHES.clear()
        _launch.LAUNCHES.update(saved)
        ph.check(all(math.isfinite(stats[n]["ms"]) for n in instances),
                 "all kernel instances timed")

    # ---- 6. report ------------------------------------------------------------
    wall = time.perf_counter() - T0
    ok_wall = wall < WATCHDOG_S
    log(f"{'ok  ' if ok_wall else 'FAIL'} the whole run: {wall:.2f} s (watchdog {WATCHDOG_S} s)")
    if not ok_wall:
        failures.append(f"6 report: the run took {wall:.2f} s, past {WATCHDOG_S} s")
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": stats[name]["launches"], "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
         "bound_ms": stats[name]["bound_ms"], "bound_by": stats[name]["bound_by"],
         "library_ms": stats[name]["library_ms"],
         **{k_: stats[name][k_] for k_ in ("device_ms", "device_ms_source", "library_device_ms",
                                          "library_device_ms_source") if k_ in stats[name]}}
        for name, (_, src, replaces, _) in instances.items()]}
    if failures:
        for f in failures:
            print(f"FAILED {f}", file=sys.stderr, flush=True)
        return 1
    print(smi, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.exit(main())
