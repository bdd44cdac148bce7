"""Smoke run of the PyTorch port (svd_xtend_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, each of which raises on failure (non-zero exit):
  1. device: needs CUDA; prints the card's name and power limit and the TF32
     switches (both off).
  2. build: compiles the CUDA kernels from csrc/ (nvcc, sm_90a, one process
     per source, in parallel).
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, in bf16, at the shapes the main paths give it; the forward
     bound is 4 bf16 ulps of the output's scale (the kernel and its plain
     version round the same products at different points). The flash
     backward kernels (dQ, dK/dV) are held, like the plain bf16 gradient,
     against the f32 plain gradient: the kernels' max-abs error must be
     finite and at most 1.5x the plain bf16 one's; the forward's LSE against
     logsumexp of the f32 scores. For each kernel at the UNet's L0 shape: its
     time, its plain version's, one PyTorch library call's computing the same
     function where there is one (SDPA, F.group_norm, F.conv2d), and the
     bound (the larger of its products over 989 TFLOP/s and its bytes, each
     input read once and each output written once, over 3.35 TB/s: the H100
     SXM's dense bf16 and HBM peaks). The flash forward is timed at all four
     UNet levels at batch 28 and 14 without the LSE (generate's CFG pair and
     cond-only passes) and at batch 14 with it (the train step), the flash
     backward pair at the four training shapes, each in the host loop and as
     device time per launch of a CUDA graph, with its executed TFLOP/s beside
     the bound (and SDPA's device time beside the forward).
     The frame attention at the four UNet levels (CFG batch 2 x 14 frames,
     and the train step's 1 x 14) as device time per launch in a CUDA graph
     beside SDPA over frames and the bound, two runs the same bits.
     GroupNorm(+SiLU) at every site of the exact video and the train step
     (GN_SITES: the UNet's on the cluster kernel, the VAE's on the two
     passes), against its plain version, two runs the same bits; device time
     per launch in a CUDA graph beside F.group_norm's (on the same values
     laid out channels-first, no SiLU) and the bound.
     GEGLU at its eight (T, C) shapes: device time per launch in a CUDA
     graph beside the bound and the unfused bf16 module path's device time
     (two runs must give the same bits).
  3a. temporal resnet: kernels A and B at every shape of the exact video
     and the train step (TRESNET_SITES), each against its plain version, the
     block against temporal_resnet_reference, two runs the same bits. Kernel
     A's statistics partials pass two gates, each beside a control it must
     catch: their channel sums against conv_a_reference's within
     temporal_resnet.sums_tolerance (8e-3 / sqrt(rows a sample); the control
     truncates the plain f32 h to bf16 instead of rounding it), and slot by
     slot within 1e-5 of the plain statistics of the kernel's own stored h
     (the control takes the plain statistics before h's rounding); the
     sums' gate again over 16 more seeds at the 560-row sites. Device ms per
     launch in a CUDA graph beside F.conv2d of the frame conv alone and the
     bound, the plan, and Σ launches x device ms per exact video and per
     train step; kernel A's norm2 fold (sc2, sh2), folded after its last
     tile, within 1e-4 of the plain fold of its h and bit for bit the fold
     kernel's from that h, under the shape's plan and, where it splits K, the
     unsplit plan too; at the UNet levels (and the VAE decoder's top) the
     block's device time split into norm1's fold and the kernels (with
     their prologue passes; three launches, no fold of norm2's own), and its
     host ms. Then the GroupNorm fold (one launch: statistics, a grid
     barrier, the fold) at the L0 temporal x, the UNet's L0 norm1 and the
     VAE decoder's top: partials, sc and sh against their plain versions,
     the same bits over two calls, three CUDA-graph replays and
     fold_from_partials (the same kernel over given partials); device and
     host ms.
  3b. conv3x3: the kernel against its plain version at every site of the
     UNet (CFG batch 28 for generate, batch 14 for the train step, each with
     the epilogue that site uses), at every dU shape of the train step's
     backward, and at every VAE site (decode and train-encode chunks of 8
     frames, the image encode at batch 1); two runs must give the same
     bits; per site device ms per launch in a CUDA graph of the kernel and
     of F.conv2d alone (bf16, channels-last, with bias), the bound, the
     plain version's ms and the launch plan; per path the sums of launches
     x device ms of both, per UNet step, train step and exact video (the
     site tables, svd_xtend_tpu_torch/scripts/sites.py, give the
     launches). The BSHD flash entry point at the L0 CFG shape.
  3d. upsample: the parity-decomposed upsample kernel (csrc/upsample_conv.cu)
     at every UPSAMPLE_SITES site (the UNet's three at CFG batch 28 and
     training batch 14, the VAE decoder's three per chunk of 8 and of 6
     frames) against its plain version (the bf16 bound), two runs the same
     bits; device ms per launch in a CUDA graph beside interpolate +
     F.conv2d 3x3 (the materialised form, the library time), four cuDNN
     2x2 convs and the bound; Σ launches x device ms per exact video and
     train step.
  3e. split concat: at every up-block conv1 site (UP_SPLIT_SITES, batch 28)
     the two-part GroupNorm fold (1e-4) and conv3x3's two-source prologue
     (the bf16 bound) against their plain versions; device ms of the split
     form beside cat + fold + conv, Σ per CFG UNet pass.
  3f. int8: the int8 quantise kernel (csrc/int8_quant.cu) and the int8 GEMM
     (csrc/int8_gemm.cu) at every int8 site: each Conv3x3 of a CFG UNet pass
     (INT8_CONV_SITES, batch 28: the conv3x3 sites and conv_out; the up
     blocks' conv1 with its two sources), of a decode chunk of 8 frames
     (INT8_VAE_CONV_SITES: and the decoder's conv_in and conv_out) and each
     QLinear of a CFG pass (INT8_DENSE_SITES; the quantise of their inputs by
     INT8_QUANTISE_SITES, net.2's with the gate, beside the module path it
     replaces: F.gelu, the product, the quantise). First the quantise's
     proofs (its codes against the IEEE division over every bf16 pair, its
     SiLU over every f32 |a| <= 16, its GELU table over every bf16 gate
     value). Codes, (amax, scale) and outputs bit for bit against the plain
     versions on the same inputs, two runs the same bits; device ms per
     launch in a CUDA graph of the quantise and the GEMM apart (the GEMM under its plan: the wgmma
     kernels on the shared TMA mainloop, the mma.sync kernel at the edge
     convs), the mma.sync kernel launched with its explicit plan beside it
     (bit for bit too), the bf16 conv3x3 kernel at the same site (where it
     takes it), F.conv2d bf16, bf16 F.linear and torch._int_mm + the plain
     dequantise (the dense's library time; its int32 sums checked exact),
     and the bound at 1,979 TOP/s int8; Σ launches x device ms per CFG
     pass, decode chunk and video, each GEMM's beside the mma.sync kernel's.
  3c. probe kernels: the kernels of the TPU probe scripts against their plain
     versions: the four softmax organisations of the flash forward
     (flash_variants) at the variants probe's shapes, (140, 2560) whole (also
     each mode's device time in a CUDA graph beside SDPA's) and
     (280, 2304), (250, 9216) on their first 8 heads (the plain version of
     those would hold ~85 GB of f32 scores), nosoftmax on positive inputs;
     the head-sliced forward with its LSE at the head-slice probe's shapes;
     the bf16 and int8 chains at the int8 probe's tiles for 1, 2 and 4 steps
     (int8 bit for bit, twice), timed at 60 at each tile with the probe's
     int8 / bf16 ratio. Each timed beside its bound, plain version and
     library call (SDPA; none for the chains).
  4. whole UNet: full SVD widths on a 2-frame 16x16 latent (all kernels
     engage), bf16 with the kernels on the card against f32 with the plain
     versions on the host CPU, from the same seeded weights: the forward
     output, then the gradient of edm_denoising_loss (fixed draws) with
     respect to the temporal-scope parameters, also against the card's bf16
     plain path (ops/kernels/dispatch.plain_versions); then the same for
     the gradient with respect to a LoRA adapter on every attention
     projection (seeded nonzero B, remat "block"). V2: the forward with
     the JAX package's default forms (split concat, parity upsample) held
     as above, and printed beside the same UNet with the materialised forms
     (torch.cat, interpolate + 3x3 conv, as plain ops here); no aten.cat in
     the up blocks' spatial resnets or upsamplers (a dispatcher spy); the
     full-width VAE decoder on a (1, 2, 16, 16, 4) latent, bf16 with the
     parity upsample against f32 on the host (rel-L2 <= 5e-2), the
     materialised upsample beside it.
  4b. int8 UNet: the full-width UNet on a CFG pair (2 x 2 frames, 16x16) in
     int8 mode, bf16 on the card against f32 on the host from the card's
     bf16 weights: every int8 site of the card's pass bit for bit its plain
     version on the same inputs (teacher-forced, the count held to the site
     tables); the card's own int8 error (int8 against exact) within
     [1/1.25, 1.25] x the host's; the card against the host within 1.25 x
     the host's own sensitivity to its weights' rounding (the int8 pass is
     chaotic in its codes; INT8_NOISE_RATIO). The distance beside bf16's
     5e-2 bound, printed and not a gate.
  5. generate (the serving path): ``generate`` at the default PipelineConfig
     (512x320, 14 frames, 25 Euler steps, stacked CFG, decode chunks of 8)
     with the full UNet, VAE and CLIP in bf16 from seeded random weights,
     batch 1, GEGLU kernel on: one warm-up run, then 1 timed run (the
     median s/video is reported, beside each run's and the device memory
     segments the allocator added during it); the last run's forward-kernel
     launch counts must all be > 0; the flash forward's, GEGLU's, the
     temporal resnet's, the frame attention's, GroupNorm's and the
     upsample's launches per video by shape (the exact video's temporal
     resnet, GroupNorm and upsample launches held against TRESNET_SITES,
     GN_SITES and UPSAMPLE_SITES; each mode's upsample launches against the
     UNet's structure: 81, 81 and 33), and their sums of launches x the
     kernel phases' device ms at each shape. Then utils.metrics on the
     card: video_report of the exact video and clip_fvd(exact, k3).
  5b. int8 videos: generate at PipelineConfig() with unet_quant="int8",
     with both modes and with int8 + the CFG cache k3 (warm-up + 1 timed
     each, the median), beside the exact video of the same models, image
     and noise: s/video, peak memory, rel-L2 and PSNR (utils/metrics.py)
     against the exact video; the int8 GEMM's conv launches held to 46 a
     UNet pass (+ 30 a decode chunk under vae_quant), its dense launches to
     320 a pass (by shape to INT8_DENSE_SITES in the int8 video), the
     quantise's to 302 a pass (by shape to INT8_QUANTISE_SITES), F.gelu's to
     the exact video's, GEGLU none, conv3x3 the VAE's alone;
     the int8 weight codes' bytes; unet_quant's Σ device time over one
     more video traced by torch.profiler, and the int8 kernels' share of it,
     beside its host clock.
  5c. eval: the evaluation entry points through their main()s.
     scripts/eval_approx.py at 512x320x14f, 25 steps, all 12 modes
     (--iters 1), on the generate phase's seeded models, image and noise:
     the exact video bit for bit the generate phase's; the int8 mode's
     PSNR to exact the int8 phase's both-modes figure to 0.01 dB; every
     mode's timed video held to the site tables (the flash forward's,
     the upsample's and conv3x3's launches by the mode's schedule, the int8
     GEMMs' and the quantise's where no pass is shallow), every kernel of
     the exact (or int8) video launched, and the exact, k3, n3+k3 and int8
     modes' launches of every kernel equal to the generate and int8
     phases'; every mode's row printed. Then scripts/eval_tracklet.py at
     --steps 50 --infer_steps 4 (its TINY networks in f32): the JAX
     script's summary schema, tracklet_weights.safetensors read back, the
     kernels the run launches by kernel (group_norm_silu alone takes f32),
     and its denoiser probe on the card against the same probe on the host
     CPU (plain versions) from the same weights, draws and noise, within
     1e-4 of the largest MSE and the probe's rounding to 5 decimals.
  6. train (this slice's main path): the default TrainConfig (temporal
     scope, 512x320x14f, batch 1, remat "block", AdamW with f32 masters,
     bf16 compute) through make_optimizer/create_train_state/make_train_step
     on a seeded synthetic batch in [-1, 1]: one warm-up step, then 3 timed
     steps whose launch counts of every kernel (forward and flash backward)
     must all be > 0; finite loss and grad_norm, trainable weights changed,
     frozen ones bit-identical; s/step and peak memory; the flash backward
     pair's, the flash forward's, GEGLU's, the temporal resnet's, the frame
     attention's, GroupNorm's and the upsample's launches per step by level
     (the flash backward's held against FLASH_BWD_SITES, the temporal
     resnet's, GroupNorm's and the upsample's against TRESNET_SITES,
     GN_SITES and UPSAMPLE_SITES, conv3x3's and dU's
     against the conv site tables), and their sums of launches x the kernel
     phases' device ms at that level. Then two asynchronous saves of the
     state (train/checkpoint.py), each followed by a step while its writer
     runs: the seconds each held the loop (the first allocates the pinned
     buffers, the second reuses them) beside the writer's, the files equal
     to the state at each save. Then one full-scope step at the same size:
     finite loss, peak memory.
  6b. lora: TrainConfig(train_mode="lora") (rank 4, alpha 4, the same size
     and batch) through the same entry points: a warm-up and 3 timed steps
     held to the same tables (FLASH_BWD_SITES' 'lora' column: every spatial
     self-attention), every base UNet, VAE and CLIP weight bit-identical
     after them, B exactly zero at the 64 one-token cross-attention q/k
     targets and nonzero at every other; s/step (median), peak memory, the
     priced kernel sums. Then serving: the adapter exported with
     export_lora_diffusers and read back bit for bit with the port's own
     safetensors reader, merge_d into the UNet (one target checked bit for
     bit against merge), and one exact video at PipelineConfig() after a
     warm-up one, whose launches must equal the exact path's. Then files:
     the VAE written as a diffusers component in two shards and an index,
     loaded with load_diffusers_checkpoint into a fresh VAE on the card,
     every tensor bit for bit.
  6c. cli (the training harness, train/cli.py, through main() in process,
     as ``python -m svd_xtend_tpu_torch.train.cli`` runs it): the machine's
     decoding tools (g++, libjpeg, nvJPEG, PIL, cv2, imageio); the native
     frame loader built from native/frame_loader.cpp into _build/native/
     (libjpeg, else the built-in baseline decoder), its decode of the
     committed window (data/fixtures) against the JAX package's committed
     output, bit for bit; run A over the committed frame
     folder at 512x320x14f (temporal scope, bf16, remat block, lr 1e-5
     constant, seed 123): 4 steps, checkpoints at 2 and 4 (limit 2),
     validation at 1 and 4 (25 Euler steps); run B: checkpoint-2 copied into
     a fresh directory, resumed from 'latest' to 4. Run B's checkpoint-4
     against run A's: masters, both moments, counts, step and data step bit
     for bit, else a second straight run A2 and the resumed difference at
     most the straight one. Each run's launches per train step equal the
     train phase's per step, each validation video's the exact video's; the
     files (params lists, metrics.jsonl, val_img_4.gif read by PIL as
     GIF89a of 14 frames, the f32 UNet export loading with strict=True); s/step from
     metrics.jsonl, the loader's host s per batch and the time next()
     blocked, checkpoint bytes, the seconds each asynchronous save held the
     loop beside its writer thread's, the snapshot's pinned bytes and the
     process's peak resident host memory, restore s, validation s, peak
     memory and the val/* metrics, beside the card's name and power limit.
  6g. parallel: train/cli.py over a world of one rank (NCCL through the env
     rendezvous on localhost, as torchrun starts a rank) over the committed
     frames at 512x320x14f: the full scope for 3 steps without offload and
     with --host_offload masters and masters+moments (s/step, peak memory,
     the bytes streamed a step; each offload must stream and lower the
     peak), then the temporal scope for 2 steps with --zero1 and without,
     whose checkpoint-2 states must be equal bit for bit.
  6h. frames (sequence parallelism, parallel/frames.py): the one-rank runs
     first, then two ranks, each a process of its own on the one card (a
     gloo group on localhost, every collective staged through host memory;
     NCCL refuses two ranks on one device), from the same seeded weights
     (flax laws, full widths) and inputs: the UNet's CFG pass at
     512x320x14f (each rank its 7 frames) against the one-rank pass, in f32
     on the plain versions (rel-L2 <= 1e-4) and in bf16 on the kernels
     (within 1.25x the distance of the one-rank pass run as two passes of
     batch 1, whose kernels take other launch plans as a shard's do; the
     aim of 1e-2 printed beside it), generate at PipelineConfig(num_inference_steps=2) (the whole
     video on both ranks, the same bits, within rel-L2 5e-2 of the one-rank
     video), the first default temporal-scope step's loss and grad_norm
     within 1e-2 relative; the int8 quantise kernel over the frames group
     (its two passes with the partial amaxes all-reduced between them: each
     rank's codes its frames of the one-rank codes, bit for bit); the frame
     attention and the temporal resnet see all 14 frames (by call shape);
     every main-path kernel launched on each rank in the timed video and
     the timed step. Each rank's s/video, s/step, peak memory and the bytes
     staged through the host a CFG pass, a video and a step, beside the
     one-rank figures and the card's name and power limit. Then an uneven
     split: 14 frames over four ranks (4, 4, 3, 3), generate for 2 steps
     against the one-rank video (rel-L2 5e-2), the ranks' videos the same
     bits, the frame attention and temporal resnets seeing all 14 frames,
     every forward kernel launched on each rank.
  6i. model (tensor parallelism, parallel/tensor.py): the one-rank runs,
     then two gloo ranks on the one card, from the same seeded weights: the
     UNet's CFG pass (f32 plain versions within 1e-4; bf16 at 1e-2 or 1.25x
     the one-rank launch-plan control, each row-parallel product as two
     K-slices whose bf16 partials are summed in rank order), generate for 2
     steps (5e-2) and two temporal-scope steps (JAX's bounds 2e-4 / 2e-3 on
     loss / grad_norm, or 1.25x the control's distance); then one step each
     in the 'lora' scope, with 8-bit AdamW, with host_offload
     "masters+moments" and with an attention processor that mixes heads
     (every head gathered for it), from the same start, held the same way,
     the masters changed; and one model-axis 8-bit update of every split
     tensor of the temporal scope on seeded whole gradients, whose codes and
     scales must be the one-rank update's at each rank's values bit for
     bit. Launches of the partial GEGLU and of the attention kernels at the
     local heads, the collectives a pass, peaks and staged bytes.
  6d. tracklet (Tracklet2Video, models/tracklet.py): the flash forward at
     the gated attention's (S_q, S_kv) = (S, S + 16 box tokens) of the four
     UNet levels at batches 28 and 14, then with its LSE and the backward
     pair at the 'tracklet' step's batch 14, each against its plain version
     with device ms beside SDPA's; the full-width UNet with the branch at
     gate 0.5 and 16 boxes against the host f32 UNet (output rel-L2 <= 5e-2;
     the branch gradient < 0.1 and <= 1.25x the bf16 plain path's); at
     gate 0 the exact video with 16 boxes equal to the branch-free video bit
     for bit; at gate 0.5 the exact, k3 and n3+k3 videos with boxes (warm-up
     + 1 timed each): the flash forward's calls by (batch, S_q, S_kv) held to
     the schedule x sites.flash_calls_per_pass, every other kernel's
     launches equal to the same mode's without boxes, s/video and peak; the
     'tracklet' step (warm-up + 3 timed) held to the site tables like the
     temporal step (the backward pair to FLASH_BWD_SITES['tracklet']), the
     flash forward twice the temporal step's, every other launch equal,
     the branch's masters changed and every other weight bit-identical;
     then ``train.cli --train_mode tracklet`` for 2 steps over the committed
     frames with a seeded boxes.npz per video: launches per step equal the
     tracklet step's, params_train.txt the branch, tracklet_weights.safetensors
     in the JAX package's flat paths mapping onto a tracklet UNet's branch.
  6e. infer: every kernel at its 1024x576 L0 shape and the VAE's against its
     plain version with device ms; then ``python -m
     svd_xtend_tpu_torch.scripts.infer_svd`` (through runpy, in process) at
     its defaults (1024x576, 14 frames, 30 steps) on a committed frame with
     16 --boxes, a random-weight pipeline directory, a LoRA file and a
     tracklet file written by the port's exporters: the flash forward's calls
     held to 30 CFG passes x flash_calls_per_pass(576, 1024, 16), the mp4
     and the GIF of 14 frames, the video finite; s/video, the entry point's
     wall time, peak.
  6f. optim8: one warm-up and one timed full-scope step with use_8bit_adam,
     then with grad_dtype="bf16" (s/step, peak, the moments' bytes), and
     the 8-bit AdamW on the card against the CPU for 3 steps on a mixed tree,
     its blocks cut in each tensor's JAX order: the int8 codes apart in at
     most 1e-4 of the values, each by one (the first codes printed).
  7. mha (the head-major attention entry point, ops/attention.py::mha, as a
     caller outside the UNet uses it): the UNet's L0 self-attention shape,
     (2x14, 2560, 320) in 5 heads of 64, through the BSHD flash kernel: its
     launch count must be > 0, and the output within 4 bf16 ulps of
     impl="plain".
  8. probes (the path of the three probe scripts): their main()s through the
     entry points of svd_xtend_tpu_torch/scripts at the scripts' shapes; each
     probe kernel's launch count must be > 0.
  9. the kernels JSON line (launches: the sum over the paths' timed runs,
     launches_by_path: each path's), then the device JSON line last.

The generate phase also runs the cache modes, PipelineConfig(
uncond_reuse_interval=3) and PipelineConfig(deep_cache_interval=3,
uncond_reuse_interval=3), one warm-up and one timed run each, on the exact
run's image and noise: s/video, peak memory, the distance of the video to
the exact one (reported, not held: the weights are random), the UNet passes
the schedule ran (batch, full or shallow) against the schedule's rules, and
the conv3x3 launch count against the site tables. The whole-UNet phase
checks the DeepCache split at full widths: shallow(x, full(x).deep) equals
full(x) bit for bit at cache depths 1-3.

--profile DIR additionally writes a torch.profiler table of one train step
(and its Chrome trace) into DIR.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import re
import statistics
import sys
import time

import torch
import torch.nn.functional as F

from svd_xtend_tpu_torch.scripts import card, cuda_ms, graph_ms
from svd_xtend_tpu_torch.scripts.sites import (FLASH_BWD_SITES, GEGLU_SHAPES, GN_SITES,
                                               INT8_CONV_SITES, INT8_DENSE_SITES,
                                               INT8_QUANTISE_SITES, INT8_QUANTIZE_CALLS,
                                               INT8_VAE_CONV_SITES,
                                               TRESNET_SITES, UNET_CONV_SITES,
                                               PORTRAIT_UPSAMPLE_SHAPES, UNET_DGRAD_SITES,
                                               UP_SPLIT_SITES, UPSAMPLE_SITES, VAE_DECODE_SITES,
                                               VAE_ENCODE_SITES, flash_calls_per_pass)

SEED = 0
# rel-L2 bound of the bf16 card UNet against the f32 host UNet: bf16 rounds
# every activation and weight to 8 significant bits (2^-9 ~ 2e-3 relative),
# and the error compounds over ~50 sequential residual/attention blocks
UNET_REL_L2_BOUND = 5e-2
# the temporal-scope gradient of the same comparison: below 0.1, and at most
# 1.25x the rel-L2 of the card's bf16 plain path (kernels off)
GRAD_REL_L2_BOUND = 0.1
GRAD_PLAIN_RATIO = 1.25
# the LoRA gradient of the same comparison starts from B ~ N(0, std²): its
# delta (alpha/r)·B·A has a std of 0.005, 9-18 % of the projections' weight
# std (1/sqrt(fan-in), fan-in 320-1280)
LORA_B_STD = 1e-2
# the int8 UNet against host f32 (int8_unet_phase): its codes are chaotic
# (a rounding moves a value to the next code, which moves the next
# quantiser's inputs), so two int8 passes that round differently are apart
# by about the quantisation's own error (0.04 at full width). The card's own
# int8 error is held within [1/r, r] x the host's, and its distance to the
# host's int8 pass to r x a control measured in the same run (the host's
# int8 pass from the f32 weights against the same from their bf16 values),
# r this ratio; each site is held bit for bit on its own inputs
INT8_NOISE_RATIO = 1.25
# flash backward: the kernels' max-abs error against the f32 plain gradient,
# at most this multiple of the bf16 plain gradient's
FLASH_BWD_RATIO = 1.5
# H100 SXM dense bf16 tensor-core rate and HBM3 bandwidth (NVIDIA's data
# sheet): the bound of a kernel is the larger of its products over the first
# and its bytes over the second
PEAK_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# LSE: f32 log-sum-exp of the same f32 scores summed in another order
LSE_ATOL = 1e-4
TRAIN_STEPS = 3
# timed videos per generate mode, after its warm-up; the median is reported
# (one, to keep the whole run inside its time limit)
GENERATE_TIMED = 1


def log(*a):
    print(*a, flush=True)


def bf16_bound(ref: torch.Tensor) -> float:
    scale = ref.float().abs().max().item()
    exp = torch.floor(torch.log2(torch.tensor(max(scale, 1e-30)))).item()
    return 4.0 * 2.0 ** (exp - 7)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FLOPS):
    """(least time in ms, "operations" or "bytes"); `peak` the operations'
    rate (bf16 by default)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class KernelPhase:
    """Holds kernel results against plain versions; keeps the worst error."""

    def __init__(self):
        self.err = {}
        self.times = {}
        self.bwd_ms = {}    # (S_q, S_kv) -> device (dQ ms, dK/dV ms) at the train step's batch
        # path ("generate": no LSE, "train": with it) -> {(batch, S_q, S_kv): forward device ms}
        self.fwd_ms = {"generate": {}, "train": {}}
        self.geglu_ms = {}      # (T, C) -> device ms per launch
        self.geglu_partial_ms = {}  # (T, C, inner) -> the partial form's device ms per launch
        self.tresnet_ms = {}    # x's shape (B, F, S, C) -> device (conv_a ms, conv_b ms)
        self.frame_ms = {}      # q's shape (B, F, S, H*64) -> frame attention device ms
        self.gn_ms = {}         # (x's shape, silu) -> group_norm_silu device ms
        self.upsample_ms = {}   # x's shape (N, H, W, C) -> upsample_conv device ms

    def forward_level(self, path, b, s, h, run, sdpa, moved, t=None):
        """The flash forward at one (batch, queries S, keys t (S by
        default), heads): host loop and device time in a CUDA graph beside
        SDPA's device time and the bound; the device time prices the path's
        launches at that shape."""
        t = s if t is None else t
        flops = 4 * b * h * s * t * 64
        host, dev_ms, sdpa_ms = cuda_ms(run), graph_ms(run), graph_ms(sdpa)
        b_ms, b_by = bound_ms(flops, moved)
        self.fwd_ms[path][(b, s, t)] = dev_ms
        if (path, b, s, t) == ("generate", 28, 2560, 2560):     # the kernels line's shape
            self.times["flash_attention_fwd"]["device_ms"] = dev_ms
        log(f"  flash forward {path} {(b, s, h * 64)} keys {t} heads {h}: {host:.4f} ms, device "
            f"{dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} TFLOP/s), SDPA device {sdpa_ms:.4f} "
            f"ms; bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / dev_ms:.1f} % of it")

    def check(self, name, got, ref, label):
        torch.cuda.synchronize()
        got, ref = got.float(), ref.float()
        if not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"{name} {label}: non-finite output")
        err = (got - ref).abs().max().item()
        rel = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        bound = bf16_bound(ref)
        log(f"  {name} {label}: max_abs_err {err:.6g} (bound {bound:.6g}) rel_l2 {rel:.3g}")
        if err > bound:
            raise RuntimeError(f"{name} {label}: error {err} above bound {bound}")
        self.err[name] = max(self.err.get(name, 0.0), err)

    def check_grad(self, name, got, plain, ref32, label):
        """got (kernel) and plain (bf16 plain version) against ref32."""
        torch.cuda.synchronize()
        err = (got.float() - ref32).abs().max().item()
        perr = (plain.float() - ref32).abs().max().item()
        log(f"  {name} {label}: max_abs_err {err:.6g} vs f32; bf16 plain {perr:.6g} "
            f"(bound {FLASH_BWD_RATIO}x)")
        if not bool(torch.isfinite(got).all()) or err > FLASH_BWD_RATIO * perr:
            raise RuntimeError(f"{name} {label}: error {err} above {FLASH_BWD_RATIO} x {perr}")
        self.err[name] = max(self.err.get(name, 0.0), err)

    def time(self, name, kernel_fn, plain_fn, flops, moved, library_fn=None,
             library="none", label="L0", peak=PEAK_FLOPS):
        """Kernel, plain and library ms at one shape, beside the bound of
        `flops` products (at `peak`) and `moved` bytes."""
        k_ms, p_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn, 3)
        lib_ms = cuda_ms(library_fn) if library_fn is not None else None
        b_ms, b_by = bound_ms(flops, moved, peak)
        self.times[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                library_ms=lib_ms)
        lib = f"{lib_ms:.4f} ms ({library})" if lib_ms is not None else "none"
        log(f"  {name} {label}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, library {lib}, "
            f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.1f} GFLOP, {moved / 1e6:.1f} MB)")
        return k_ms, p_ms


def tresnet_phase(dev, ph: KernelPhase, smi: str):
    """The temporal resnet's kernels A and B at every shape of the paths
    (svd_xtend_tpu_torch/scripts/sites.py TRESNET_SITES): each against its
    plain version (kernel A's statistics as in check_tresnet_stats), the
    block against temporal_resnet_reference, two runs the same bits; device
    ms per launch in a CUDA graph beside F.conv2d of the frame conv alone (a
    (3, 1) filter, channels-last, on the pre-activated input) and the bound,
    the plan; Σ launches x device ms per exact video and per train step. At
    the UNet levels (and the VAE decoder's top) the block's device time split
    into its parts, and its host ms. Then the channel sums' bound over more
    seeds at the 560-row level, and the GroupNorm fold (fold_phase)."""
    from svd_xtend_tpu_torch.ops import video
    from svd_xtend_tpu_torch.ops.kernels import gemm_plan
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr
    log("  x (B, F, S, C) x launches per video / per step: device ms conv_a / conv_b / "
        "F.conv2d alone / bound, TFLOP/s of conv_a, conv_b; the plan")
    totals = collections.defaultdict(float)
    for b, f, s, c, per_video, per_step in TRESNET_SITES:
        x, t, k1, b1, k2, b2, sc1, sh1, w = tresnet_inputs(dev, b, f, s, c, SEED + 10)
        (wt1, b1f), (wt2, b2f) = tr.packed(k1, b1), tr.packed(k2, b2)
        g = torch.Generator(device=dev).manual_seed(SEED + 12)
        sc, bi = 1 + 0.1 * torch.randn(c, device=dev, generator=g), 0.1 * torch.randn(
            c, device=dev, generator=g)
        label = f"{(b, f, s, c)}"
        run_a = lambda: tr.conv_a(x, wt1, b1f, sc1, sh1, t, sc, bi, 32, 1e-5)
        plain_a = lambda: tr.conv_a_reference(x, k1, b1, sc1, sh1, t)
        h, psum, psq, sc2, sh2 = run_a()
        rh, rsum, rsq = plain_a()
        ph.check("temporal_resnet_conv_a", h, rh, label)
        readings = check_tresnet_stats(label, (x, k1, b1, sc1, sh1, t), h, psum, psq, rh, rsum, rsq)
        log(f"    channel sums against conv_a_reference's {readings[0]:.3g}, truncated-h "
            f"control {readings[1]:.3g} (bound {tr.sums_tolerance(f * s):.3g}); slots against "
            f"the stored h's {readings[2]:.3g}, pre-rounding control {readings[3]:.3g} "
            f"(bound {SLOT_BOUND})")
        check_norm2_fold(label, x, (wt1, b1f, sc1, sh1, t), (h, psum, psq, sc2, sh2), sc, bi)
        run_b = lambda: tr.conv_b(rh, wt2, b2f, sc1, sh1, x, w)
        plain_b = lambda: tr.conv_b_reference(rh, k2, b2, sc1, sh1, x, w)
        out = run_b()
        ph.check("temporal_resnet_conv_b", out, plain_b(), label)
        again = (*run_a(), run_b())
        if not all(torch.equal(u, v) for u, v in zip((h, psum, psq, sc2, sh2, out), again)):
            raise RuntimeError(f"temporal resnet {label}: two runs differ")
        args = (x, t, k1, b1, k2, b2, sc, bi, sc, bi, w)
        block = lambda: tr.temporal_resnet_block(*args, groups=32, eps=1e-5)
        ph.check("temporal_resnet_block", block(), tr.temporal_resnet_reference(*args, 32, 1e-5),
                 label)
        flops = 2 * b * f * s * 3 * c * c
        moved_a, moved_b = nbytes(x, x, wt1, t), nbytes(x, x, x, wt2)
        if (b, f, s, c) == (2, 14, 2560, 320):   # the kernels line's shape
            ph.time("temporal_resnet_conv_a", run_a, plain_a, flops, moved_a)
            ph.time("temporal_resnet_conv_b", run_b, plain_b, flops, moved_b)
        a_ms, b_ms = graph_ms(run_a), graph_ms(run_b)
        ph.tresnet_ms[(b, f, s, c)] = a_ms, b_ms
        u = video.nchw(tr._activate(x, sc1, sh1))       # (B, C, F, S), channels-last
        w31 = k1.permute(2, 1, 0)[..., None].contiguous(memory_format=torch.channels_last)
        lib_ms = graph_ms(lambda: F.conv2d(u, w31, b1, padding=(1, 0)))
        bound, by = bound_ms(flops, moved_a)
        if (b, f, s, c) == (2, 14, 2560, 320):
            ph.times["temporal_resnet_conv_a"]["device_ms"] = a_ms
            ph.times["temporal_resnet_conv_b"]["device_ms"] = b_ms
        plan = gemm_plan.tresnet_plan(b, f, s, c)
        log(f"  temporal resnet {label} x {per_video} / {per_step}: {a_ms:.4f} / {b_ms:.4f} / "
            f"{lib_ms:.4f} / {bound:.4f} ms ({by}), {flops / a_ms / 1e9:.1f} / "
            f"{flops / b_ms / 1e9:.1f} TFLOP/s; bn {plan.bn} ks {plan.k_slices} grid {plan.grid}")
        for path, n in (("exact video", per_video), ("train step", per_step)):
            for key, v in (("a", a_ms), ("b", b_ms), ("conv2d", 2 * lib_ms), ("bound", 2 * bound)):
                totals[path, key] += n * v
        if b == 2 or (b, f, s) == (1, 8, 163840):
            tresnet_block_parts(label, x, sc, bi, sc1, sh1, a_ms, b_ms, block)
        del x, h, rh, out, again, u
    for path in ("exact video", "train step"):
        a, b_, lib, bound = (totals[path, k] for k in ("a", "b", "conv2d", "bound"))
        log(f"  [{smi}] temporal resnet per {path}: launches x device ms, conv_a {a:.1f} + "
            f"conv_b {b_:.1f} = {a + b_:.1f} ms; F.conv2d alone (both convs) {lib:.1f}; "
            f"bound {bound:.1f}")
    tresnet_sums_seeds(dev)
    fold_phase(dev, ph)


SLOT_BOUND = 1e-5   # kernel A's partials against the plain statistics of its own h
FOLD_BOUND = 1e-4   # a fold's (sc, sh) against the plain fold (allclose atol and rtol)


def check_norm2_fold(label, x, a_args, got, scale2, bias2):
    """Kernel A's norm2 fold (sc2, sh2): within FOLD_BOUND of the plain fold
    of its stored h, and bit for bit the fold kernel's (statistics from h in
    device memory, then the same fixed-order fold); under the shape's plan
    and, where that splits K, under the unsplit plan too (h may then differ
    in the last bit; the fold of each h must not)."""
    from dataclasses import replace

    from svd_xtend_tpu_torch.ops.kernels import gemm_plan
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr

    b, f, s, c = x.shape
    plan = gemm_plan.tresnet_plan(b, f, s, c)
    runs = [("plan", got)]
    if plan.k_slices > 1:
        whole = replace(plan, k_slices=1)
        whole = replace(whole, grid=min(whole.n_items, plan.grid))
        runs.append(("unsplit", tr.conv_a(x, *a_args, scale2, bias2, 32, 1e-5, plan=whole)))
    for name, (h, psum, psq, sc2, sh2) in runs:
        ref = tr.norm2_fold_reference(h, scale2, bias2, 32, 1e-5)
        err = max((a - r).abs().max().item() for a, r in zip((sc2, sh2), ref))
        own = gn.fold_with_partials(h, scale2, bias2, groups=32, eps=1e-5)
        same = all(torch.equal(a, o) for a, o in zip((psum, psq, sc2, sh2), own))
        log(f"    norm2 fold ({name} plan, k_slices {1 if name == 'unsplit' else plan.k_slices}):"
            f" max |err| {err:.3g} against the plain fold of its h (allclose {FOLD_BOUND}); "
            f"partials and (sc2, sh2) the fold kernel's bits from h: {same}")
        if not same or not all(torch.allclose(a, r, FOLD_BOUND, FOLD_BOUND)
                               for a, r in zip((sc2, sh2), ref)):
            raise RuntimeError(f"temporal_resnet_conv_a {label}: norm2 fold ({name}) off")


def tresnet_inputs(dev, b, f, s, c, seed):
    """Seeded (x, t, k1, b1, k2, b2, sc1, sh1, w) of a temporal resnet at
    (b, f, s, c): bf16 tensors, f32 (sc1, sh1) and blend weight w."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *sh, sc=1.0: (torch.randn(*sh, device=dev, generator=g) * sc).to(
        torch.bfloat16)
    x, t = rn(b, f, s, c), rn(b, f, c, sc=0.5)
    k1, k2 = rn(3, c, c, sc=(3 * c) ** -0.5), rn(3, c, c, sc=(3 * c) ** -0.5)
    b1, b2 = rn(c, sc=0.1), rn(c, sc=0.1)
    sc1, sh1 = (1 + 0.1 * rn(b, c).float()) / 2, 0.1 * rn(b, c).float()
    return x, t, k1, b1, k2, b2, sc1, sh1, torch.tensor([0.37], device=dev)


def check_tresnet_stats(label, a_args, h, psum, psq, rh, rsum, rsq):
    """Kernel A's statistics partials (its inputs `a_args` in
    conv_a_reference's order), two gates each beside a control that
    it must catch:
      - their channel sums against conv_a_reference's within
        temporal_resnet.sums_tolerance(rows a sample); the control is the
        sums of the plain f32 h truncated (not rounded) to bf16;
      - slot by slot against the plain statistics of the kernel's own stored
        h within SLOT_BOUND; the control is the plain statistics of the f32
        h before its rounding, against those of the plain h.
    Returns the readings (sums, sums' control, slots, slots' control): of
    the sums and the sums of squares, the larger reading of a gate and the
    smaller of a control."""
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr

    b, f, s, c = h.shape
    rel = lambda got, ref: ((got - ref).abs().max() / ref.abs().max()).item()

    def sums(v):
        v = v.float().flatten(1, 2)
        return v.sum(1), (v * v).sum(1)

    acc = tr.conv_a_f32_reference(*a_args)
    trunc = (acc.view(torch.int32) & -65536).view(torch.float32)
    own = gn.channel_stats_reference(h.reshape(-1, c), f * s)
    pre, plain = (gn.channel_stats_reference(v.reshape(-1, c), f * s) for v in (acc, rh))
    readings = [max(rel(p.sum(1), r) for p, r in zip((psum, psq), (rsum, rsq))),
                min(rel(v, r) for v, r in zip(sums(trunc), (rsum, rsq))),
                max(rel(p, o) for p, o in zip((psum, psq), own)),
                min(rel(v, p) for v, p in zip(pre, plain))]
    bound = tr.sums_tolerance(f * s)
    if not (bool(torch.isfinite(psum).all() and torch.isfinite(psq).all())
            and readings[0] <= bound < readings[1] and readings[2] <= SLOT_BOUND < readings[3]):
        raise RuntimeError(f"temporal_resnet_conv_a {label}: statistics readings {readings} "
                           f"against the bounds {bound}, {SLOT_BOUND}")
    return readings


def tresnet_sums_seeds(dev, seeds=16):
    """The channel sums' gate over `seeds` more seeds at the sites of 560
    rows a sample (the fewest, where its bound is widest): the largest
    reading and the smallest truncated-h control."""
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr

    for b, f, s, c, *_ in TRESNET_SITES:
        if f * s != 560:
            continue
        readings = []
        for i in range(seeds):
            x, t, k1, b1, *_, sc1, sh1, _ = tresnet_inputs(dev, b, f, s, c, SEED + 100 + i)
            wt1, b1f = tr.packed(k1, b1)
            a_args = (x, k1, b1, sc1, sh1, t)
            ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            got = tr.conv_a(x, wt1, b1f, sc1, sh1, t, ones, zeros, 32, 1e-5)[:3]
            ref = tr.conv_a_reference(*a_args)
            readings.append(check_tresnet_stats(f"{(b, f, s, c)} seed {i}", a_args, *got, *ref))
        log(f"    {(b, f, s, c)} over {seeds} seeds: channel sums against conv_a_reference's "
            f"at most {max(r[0] for r in readings):.3g}, truncated-h control at least "
            f"{min(r[1] for r in readings):.3g} (bound {tr.sums_tolerance(f * s):.3g}); slots "
            f"at most {max(r[2] for r in readings):.3g}, pre-rounding control at least "
            f"{min(r[3] for r in readings):.3g} (bound {SLOT_BOUND})")


def tresnet_block_parts(label, x, sc, bi, sc1, sh1, a_ms, b_ms, block):
    """The block's device ms in a CUDA graph and its parts: norm1's fold (one
    launch), the prologue pass (twice in the block, inside each kernel's
    time), kernel A (norm2's statistics in its epilogue, their fold after
    its last tile) and kernel
    B: three launches, no fold of norm2's own (the weights are packed once
    per parameter version, nothing per call); and the block's host ms per
    call (enqueue, no synchronise)."""
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr

    fold1 = graph_ms(lambda: gn.group_norm_fold(x, sc, bi, groups=32, eps=1e-5))
    prologue = graph_ms(lambda: tr.affine_silu(x, sc1, sh1))
    dev_ms = graph_ms(block)
    block()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        block()
    host = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    log(f"    block {label}: device {dev_ms:.4f} ms = fold1 {fold1:.4f} + conv_a {a_ms:.4f} "
        f"(prologue {prologue:.4f} of it; norm2's fold after its tiles) + conv_b {b_ms:.4f} "
        f"(+ prologue), 3 launches, no fold2 launch; weights 0 (packed once per version); "
        f"host {host:.4f} ms a call (enqueue)")


FOLD_SHAPES = [(2, 14, 2560, 320), (28, 40, 64, 320), (8, 320, 512, 128)]


def fold_phase(dev, ph: KernelPhase):
    """The GroupNorm fold (csrc/gn_fold.cu, one launch: statistics, a grid
    barrier, the fold)
    at the L0 temporal x, the UNet's L0 norm1 at CFG batch and the VAE
    decoder's top resnet: its partials slot by slot against
    channel_stats_reference (1e-5 relative), sc, sh within FOLD_BOUND of the
    plain fold (f32 sums in another order, E[x^2] - mean^2 as the JAX
    formula), the same bits over two eager calls and three replays of one
    CUDA graph (its barrier resets itself); fold_from_partials (the same
    kernel over given partials) the same bits again, and within FOLD_BOUND of
    the plain fold of the slot sums. Device ms in a CUDA graph beside the
    plain version and the bound (x read once); host ms a call. The L0 shape
    is the kernels line's."""
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    for shape in FOLD_SHAPES:
        x = (torch.randn(*shape, device=dev, generator=g) * 2 + 0.5).to(torch.bfloat16)
        c, rows = shape[-1], math.prod(shape[1:-1])
        scale = 1 + 0.1 * torch.randn(c, device=dev, generator=g)
        bias = 0.1 * torch.randn(c, device=dev, generator=g)
        run = lambda: gn.group_norm_fold(x, scale, bias, groups=32, eps=1e-5)
        plain = lambda: gn.group_norm_fold_reference(x, scale, bias, groups=32, eps=1e-5)
        full = gn.fold_with_partials(x, scale, bias, groups=32, eps=1e-5)
        rel = max(((got - ref).abs().max() / ref.abs().max()).item() for got, ref in
                  zip((full.psum, full.psq), gn.channel_stats_reference(x.reshape(-1, c), rows)))
        if not (bool(torch.isfinite(full.psum).all()) and rel <= 1e-5):
            raise RuntimeError(f"group_norm_fold {shape}: partials off by {rel}")
        want = (full.sc, full.sh)
        eager = [run(), run()]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static = run()
        replays = []
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            replays.append(tuple(t.clone() for t in static))
        parts = gn.fold_from_partials(full.psum, full.psq, rows, scale, bias, 32, 1e-5)
        same = all(torch.equal(a, w) for got in eager + replays + [parts]
                   for a, w in zip(got, want))
        refs = [plain(), gn.fold_from_channel_sums(full.psum.sum(1), full.psq.sum(1), rows,
                                                   scale, bias, 32, 1e-5)]
        err, slot_err = (max((a - r).abs().max().item() for a, r in zip(got, ref))
                         for got, ref in zip((want, parts), refs))
        ok = all(torch.allclose(a, r, FOLD_BOUND, FOLD_BOUND)
                 for got, ref in zip((want, parts), refs) for a, r in zip(got, ref))
        dev_ms, plain_ms, parts_ms = graph_ms(run), graph_ms(plain), graph_ms(
            lambda: gn.fold_from_partials(full.psum, full.psq, rows, scale, bias, 32, 1e-5))
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            run()
        host = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        log(f"  group_norm_fold {shape}: partials rel err {rel:.3g} (1e-5); sc, sh max |err| "
            f"{err:.4g} (allclose {FOLD_BOUND}); the same bits over 2 eager calls, 3 graph "
            f"replays and fold_from_partials: {same}; device {dev_ms:.4f} ms (one launch), "
            f"plain {plain_ms:.4f}, bound {bound_ms(0, nbytes(x))[0]:.4f} ms (bytes); host "
            f"{host:.4f} ms a call; fold_from_partials device {parts_ms:.4f} ms, max |err| "
            f"{slot_err:.4g} against the plain fold of its slot sums")
        if not (same and ok):
            raise RuntimeError(f"group_norm_fold {shape}: same bits {same}, error {err}, "
                               f"from partials {slot_err}")
        if shape == FOLD_SHAPES[0]:
            cases = (("group_norm_fold", run, plain, nbytes(x), err),
                     ("fold_from_partials",
                      lambda: gn.fold_from_partials(full.psum, full.psq, rows, scale, bias, 32,
                                                    1e-5),
                      lambda: gn.fold_from_channel_sums(full.psum.sum(1), full.psq.sum(1), rows,
                                                        scale, bias, 32, 1e-5),
                      nbytes(full.psum, full.psq), slot_err))
            for name, fn, pl, moved, e in cases:
                ph.err[name] = e
                ph.time(name, fn, pl, 0, moved + 2 * shape[0] * c * 4)      # + sc, sh
                ph.times[name]["device_ms"] = dev_ms if name == "group_norm_fold" else parts_ms
        del x, full, eager, replays, static, graph


def kernel_phases(dev) -> KernelPhase:
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
    from svd_xtend_tpu_torch.ops.kernels import geglu as gg
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
    from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta

    g = torch.Generator(device=dev).manual_seed(SEED)
    rn = lambda *s, sc=1.0: (torch.randn(*s, device=dev, generator=g) * sc).to(torch.bfloat16)
    ph = KernelPhase()

    log("kernels: flash attention (CFG batch 2x14 frames, and 14: a cond-only pass; batch "
        "14 with the LSE in the backward below)")
    for b, s, h in [(28, 2560, 5), (28, 640, 10), (28, 160, 20), (28, 40, 20),
                    (14, 2560, 5), (14, 640, 10), (14, 160, 20), (14, 40, 20)]:
        q, k, v = rn(b, s, h * 64), rn(b, s, h * 64), rn(b, s, h * 64)
        run = lambda: fa.flash_attention_packed(q, k, v, num_heads=h, scale=0.125)
        plain = lambda: fa.flash_attention_packed_reference(q, k, v, num_heads=h, scale=0.125)
        ph.check("flash_attention_fwd", run(), plain(), f"{(b, s, h * 64)} heads {h}")
        heads = lambda a: a.view(b, s, h, 64).transpose(1, 2)
        sdpa = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v), scale=0.125)
        if (b, s) == (28, 2560):
            ph.time("flash_attention_fwd", run, plain, 4 * b * h * s * s * 64,
                    nbytes(q, k, v, q), sdpa, "SDPA")
        ph.forward_level("generate", b, s, h, run, sdpa, nbytes(q, k, v, q))
        del q, k, v

    log("kernels: frame attention (device ms per launch in a CUDA graph at the four UNet "
        "levels, CFG batch 2 x 14 frames and the train step's 1 x 14)")
    for b, f, s, h in [(2, 14, 2560, 5), (2, 14, 640, 10), (2, 14, 160, 20), (2, 14, 40, 20),
                       (1, 14, 2560, 5), (1, 14, 640, 10), (1, 14, 160, 20), (1, 14, 40, 20)]:
        q, k, v = rn(b, f, s, h * 64), rn(b, f, s, h * 64), rn(b, f, s, h * 64)
        run = lambda: ta.frame_attention(q, k, v, num_heads=h, scale=0.125)
        plain = lambda: ta.frame_attention_reference(q, k, v, num_heads=h, scale=0.125)
        got = run()
        ph.check("frame_attention_fwd", got, plain(), f"{(b, f, s, h * 64)}")
        if not torch.equal(got, run()):
            raise RuntimeError(f"frame_attention_fwd {(b, f, s, h * 64)}: two runs differ")
        frames = lambda a: a.view(b, f, s, h, 64).permute(0, 2, 3, 1, 4)
        sdpa = lambda: F.scaled_dot_product_attention(frames(q), frames(k), frames(v),
                                                      scale=0.125)
        flops, moved = 4 * b * s * h * f * f * 64, nbytes(q, k, v, q)
        if (b, s) == (2, 2560):
            ph.time("frame_attention_fwd", run, plain, flops, moved, sdpa, "SDPA over frames")
        dev_ms, sdpa_ms = graph_ms(run), graph_ms(sdpa)
        ph.frame_ms[tuple(q.shape)] = dev_ms
        if (b, s) == (2, 2560):
            ph.times["frame_attention_fwd"]["device_ms"] = dev_ms
        b_ms, b_by = bound_ms(flops, moved)
        log(f"  frame attention {(b, f, s, h * 64)} heads {h}: device {dev_ms:.4f} ms, SDPA over "
            f"frames device {sdpa_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / dev_ms:.1f} % of it; plan {ta.frame_plan(f)}")
        del q, k, v

    log("kernels: GroupNorm(+SiLU) at every site of the exact video and the train step "
        "(GN_SITES; x*3 + 1): device ms per launch in a CUDA graph beside F.group_norm's on "
        "the same values channels-first and the bound; two runs the same bits")
    for shape, silu, eps in sorted({st[:3] for st in GN_SITES}):
        x = rn(*shape) * 3 + 1
        c = shape[-1]
        sc, bi = 1 + 0.1 * rn(c).float(), 0.1 * rn(c).float()
        run = lambda: gn.group_norm_silu(x, sc, bi, groups=32, eps=eps, silu=silu)
        plain = lambda: gn.group_norm_silu_reference(x, sc, bi, 32, eps, silu)
        got = run()
        ph.check("group_norm_silu", got, plain(), f"{shape} silu={silu}")
        if not torch.equal(got, run()):
            raise RuntimeError(f"group_norm_silu {shape}: two runs differ")
        del got
        xcf = x.reshape(shape[0], -1, c).transpose(1, 2).contiguous()
        library = lambda: F.group_norm(xcf, 32, sc.to(x.dtype), bi.to(x.dtype), eps)
        if (shape, silu) == ((28, 40, 64, 320), False):
            ph.time("group_norm_silu", run, plain, 0, nbytes(x, x), library,
                    "F.group_norm, channels-first")
        dev_ms, lib_ms = graph_ms(run), graph_ms(library)
        ph.gn_ms[(shape, silu)] = dev_ms
        if (shape, silu) == ((28, 40, 64, 320), False):
            ph.times["group_norm_silu"]["device_ms"] = dev_ms
        b_ms, _ = bound_ms(0, nbytes(x, x))
        plan = gn.group_norm_plan(shape, x.dtype, 32)
        log(f"  group_norm_silu {shape} silu={silu}: device {dev_ms:.4f} ms, F.group_norm "
            f"(channels-first, no SiLU) device {lib_ms:.4f} ms, bound {b_ms:.4f} ms (bytes), "
            f"{100 * b_ms / dev_ms:.1f} % of it; {plan.path}"
            + (f", {plan.rows_per_cta} rows a CTA" if plan.rows_per_cta else ""))
        del x, xcf

    log("kernels: fused residual GEGLU (T x C at the four UNet levels: training, then "
        "serving with CFG, 2T); device ms per launch in a CUDA graph")
    for t, c in GEGLU_SHAPES:
        args = [rn(t, c), 1 + 0.1 * rn(c), 0.1 * rn(c), rn(8 * c, c, sc=c ** -0.5),
                0.1 * rn(8 * c), rn(c, 4 * c, sc=(4 * c) ** -0.5), 0.1 * rn(c)]
        run = lambda: gg.ln_geglu_residual(*args)
        plain = lambda: gg.ln_geglu_residual_reference(*args)
        got = run()
        ph.check("geglu_fwd", got, plain(), f"T {t} C {c}")
        if not torch.equal(got, run()):
            raise RuntimeError(f"geglu_fwd T {t} C {c}: two runs differ")
        x, ls, lb, w1, b1, w2, b2 = args
        ln = torch.nn.LayerNorm(c, device=dev, dtype=torch.bfloat16)
        ln.weight.data.copy_(ls)
        ln.bias.data.copy_(lb)
        b1b, b2b = b1.to(torch.bfloat16), b2.to(torch.bfloat16)

        def module_path():
            h, g = torch.nn.functional.linear(ln(x), w1, b1b).chunk(2, dim=-1)
            return x + torch.nn.functional.linear(
                h * torch.nn.functional.gelu(g, approximate="tanh"), w2, b2b)
        flops, moved = 24 * t * c * c, nbytes(x, x, w1, w2)
        if t == 35840:
            ph.time("geglu_fwd", run, plain, flops, moved)
        ph.geglu_ms[(t, c)] = dev_ms = graph_ms(run)
        if t == 35840:
            ph.times["geglu_fwd"]["device_ms"] = dev_ms
        mod_ms = graph_ms(module_path)
        b_ms, b_by = bound_ms(flops, moved)
        plan = getattr(gg, "geglu_plan", None)  # absent in trees before the plans
        plan = "" if plan is None else "; ".join(
            f"bn {p.bn} ks {p.k_slices} grid {p.grid}" for p in plan(t, c))
        log(f"  geglu_fwd T {t} C {c}: device {dev_ms:.4f} ms ({flops / dev_ms / 1e9:.1f} "
            f"TFLOP/s), unfused bf16 module path (LayerNorm + cuBLAS GEMMs + gate) device "
            f"{mod_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); plan {plan}")
        del args

    geglu_partial_phase(ph, rn)

    log("kernels: flash attention forward with LSE and backward (training batch 14 frames)")
    for b, s_len, h in [(14, 2560, 5), (14, 640, 10), (14, 160, 20), (14, 40, 20)]:
        flash_train_level(ph, rn, b, s_len, h)
    return ph


def geglu_partial_phase(ph: KernelPhase, rn):
    """The GEGLU kernel's partial form (tensor parallelism: a model rank's
    inner columns, no b2, no residual) at the full-width shard shapes of a
    model axis of 2 (inner 2C), every T of GEGLU_SHAPES, against its plain
    version; device ms per launch in a CUDA graph beside the whole form's
    at the same T and C."""
    from svd_xtend_tpu_torch.ops.kernels import geglu as gg

    log(f"kernels: GEGLU partial form at the shard shapes of a model axis of {MODEL_RANKS} "
        "(inner 4C / 2 of each level); device ms per launch in a CUDA graph")
    for t, c in GEGLU_SHAPES:
        inner = 4 * c // MODEL_RANKS
        args = [rn(t, c), 1 + 0.1 * rn(c), 0.1 * rn(c), rn(2 * inner, c, sc=c ** -0.5),
                0.1 * rn(2 * inner), rn(c, inner, sc=inner ** -0.5)]
        run = lambda: gg.ln_geglu_partial(*args)
        plain = lambda: gg.ln_geglu_partial_reference(*args)
        got = run()
        ph.check("geglu_partial", got, plain(), f"T {t} C {c} inner {inner}")
        if not torch.equal(got, run()):
            raise RuntimeError(f"geglu_partial T {t} C {c}: two runs differ")
        x, _, _, w1, _, w2 = args
        flops, moved = 6 * t * c * inner, nbytes(x, x, w1, w2)
        if t == 35840:
            ph.time("geglu_partial", run, plain, flops, moved, label=f"L0 inner {inner}")
        ph.geglu_partial_ms[(t, c, inner)] = dev_ms = graph_ms(run)
        if t == 35840:
            ph.times["geglu_partial"]["device_ms"] = dev_ms
        b_ms, b_by = bound_ms(flops, moved)
        plan = "; ".join(f"bn {p.bn} ks {p.k_slices} grid {p.grid}"
                         for p in gg.geglu_plan(t, c, inner=inner))
        whole = ph.geglu_ms.get((t, c))
        log(f"  geglu_partial T {t} C {c} inner {inner}: device {dev_ms:.4f} ms "
            f"({flops / dev_ms / 1e9:.1f} TFLOP/s), the whole form {whole:.4f} ms at inner "
            f"{4 * c}; bound {b_ms:.4f} ms ({b_by}); plan {plan}")
        del args


def flash_train_level(ph: KernelPhase, rn, b, s_len, h, t=None):
    """The flash forward with its LSE and the backward pair at the train
    step's (batch, queries S, keys t (S by default), heads): each against its
    plain version, the forward's device time, the pair's host and device
    times beside the bound; at the L0 self-attention also the JSON line's
    kernel, plain and library (SDPA) ms."""
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa

    t = s_len if t is None else t
    q, do = rn(b, s_len, h * 64), rn(b, s_len, h * 64)
    k, v = rn(b, t, h * 64), rn(b, t, h * 64)
    o, lse = fa.flash_attention_fwd(q, k, v, h, 0.125)
    ref_o, ref_lse = fa.flash_attention_fwd_reference(q, k, v, h, 0.125)
    label = f"{(b, s_len, h * 64)} keys {t} heads {h}"
    ph.check("flash_attention_fwd", o, ref_o, label)
    lerr = (lse - ref_lse).abs().max().item()
    log(f"  flash LSE {(b, s_len, t, h)}: max_abs_err {lerr:.3g} (bound {LSE_ATOL})")
    if not bool(torch.isfinite(lse).all()) or lerr > LSE_ATOL:
        raise RuntimeError(f"flash LSE error {lerr}")
    heads = lambda a: a.view(b, a.shape[1], h, 64).transpose(1, 2)
    ph.forward_level("train", b, s_len, h, lambda: fa.flash_attention_fwd(q, k, v, h, 0.125),
                     lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                            scale=0.125),
                     nbytes(q, k, v, q, lse), t)
    delta = fa.attention_delta(o, do, h)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, h, 0.125)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, h, 0.125)
    plain_fn = lambda q, k, v: fa.flash_attention_packed_reference(q, k, v, num_heads=h,
                                                                   scale=0.125)
    grads = []
    for inputs, dout in (((q, k, v), do),
                         ((q.float(), k.float(), v.float()), do.float())):
        leaves = [x.detach().requires_grad_(True) for x in inputs]
        grads.append(torch.autograd.grad(plain_fn(*leaves), leaves, dout))
    (pq, pk, pv), (rq, rk, rv) = grads
    ph.check_grad("flash_attention_bwd_dq", dq, pq, rq, label + " dQ")
    ph.check_grad("flash_attention_bwd_dkv", dk, pk, rk, label + " dK")
    ph.check_grad("flash_attention_bwd_dkv", dv, pv, rv, label + " dV")
    del grads, pq, pk, pv, rq, rk, rv
    run_dq = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, h, 0.125)
    run_dkv = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, h, 0.125)
    mm = 2 * b * h * s_len * t * 64         # one product's FLOPs
    stats = 2 * b * h * s_len * 4           # LSE and delta, f32
    work = {"dQ": (3, nbytes(q, k, v, do, q) + stats),
            "dK/dV": (4, nbytes(q, k, v, do, k, v) + stats)}
    if (s_len, t) == (2560, 2560):
        plain_bwd = lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do, h, 0.125)
        sq, sk, sv = (heads(a).detach().requires_grad_(True) for a in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(sq, sk, sv, scale=0.125)
        sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, (sq, sk, sv), heads(do),
                                               retain_graph=True)
        for name, run, (n_mm, moved) in (("flash_attention_bwd_dq", run_dq, work["dQ"]),
                                         ("flash_attention_bwd_dkv", run_dkv,
                                          work["dK/dV"])):
            ph.time(name, run, plain_bwd, n_mm * mm, moved, sdpa_bwd, "SDPA backward")
        log("    (plain and library ms of both backward kernels compute dQ, dK and "
            "dV together)")
        ms = (ph.times["flash_attention_bwd_dq"]["ms"],
              ph.times["flash_attention_bwd_dkv"]["ms"])
        del sq, sk, sv, sdpa_out
    else:
        ms = (cuda_ms(run_dq), cuda_ms(run_dkv))
    ph.bwd_ms[(s_len, t)] = (graph_ms(run_dq), graph_ms(run_dkv))
    for (name, (n_mm, moved)), k_ms, d_ms in zip(work.items(), ms, ph.bwd_ms[(s_len, t)]):
        b_ms, b_by = bound_ms(n_mm * mm, moved)
        log(f"  flash backward {name} {label}: {k_ms:.4f} ms, device {d_ms:.4f} ms; "
            f"{n_mm * mm / d_ms / 1e9:.1f} TFLOP/s executed on its {n_mm} products "
            f"(device); bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / d_ms:.1f} % of it")
    del q, k, v, do, o, ref_o, dq, dk, dv


def conv_phase(dev, ph: KernelPhase, smi: str):
    """conv3x3 and its dU launch at every site of the paths: checked against
    the plain version, timed beside F.conv2d alone (both as device time per
    launch in a CUDA graph) and the bound. Prints, per path, the sums over
    its sites of launches x device ms of the kernel and of F.conv2d."""
    from svd_xtend_tpu_torch.ops import video
    from svd_xtend_tpu_torch.ops.kernels import conv3x3 as cv

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    rn = lambda *s, sc=1.0: (torch.randn(*s, device=dev, generator=g) * sc).to(torch.bfloat16)
    log("  site (N, H, W, Ci -> Co, epilogue) x launches: device ms kernel / F.conv2d alone "
        "/ bound, kernel TFLOP/s, plain ms; the plan")

    def site(name, n, h, w, ci, co, epi, per, first=False):
        """(kernel, F.conv2d) device ms x per"""
        # x is dy (N, H, W, Ci) for dU, and the weight the forward's (Ci, Co, 3, 3)
        x = rn(n, h, w, ci) * 2 + 0.5
        shape = (co, ci) if name == "conv3x3" else (ci, co)
        weight = rn(*shape, 3, 3, sc=(9 * ci) ** -0.5).contiguous(
            memory_format=torch.channels_last)
        bias = 0.1 * rn(co)
        kw = {}
        if epi.startswith("preS"):
            kw = dict(pre_scale=(1 + 0.2 * rn(n, ci)).float() / 2,
                      pre_shift=0.3 * rn(n, ci).float(), pre_silu=True)
        if "post" in epi:
            kw["post_shift"] = 0.5 * rn(n, co).float()
        if "res" in epi:
            kw["residual"] = rn(n, h, w, co)
        if name == "conv3x3":
            run = lambda: cv.conv3x3(x, weight, bias, **kw)
            plain = lambda: cv.conv3x3_fused_reference(
                x, weight, bias, kw.get("pre_scale"), kw.get("pre_shift"),
                kw.get("post_shift"), kw.get("residual"), kw.get("pre_silu", False))
            lib_w = weight
        else:
            run = lambda: cv.conv3x3_input_grad(x, weight)
            plain = lambda: cv.conv3x3_input_grad_reference(x, weight)
            lib_w = cv.flipped_weight(weight).contiguous(memory_format=torch.channels_last)
            bias = None
        label = f"{(n, h, w, ci)} -> {co} {epi}"
        got = run()
        ph.check(name, got, plain(), label)
        if not torch.equal(got, run()):
            raise RuntimeError(f"{name} {label}: two runs differ")
        cout = lib_w.shape[0]
        flops = 2 * n * h * w * 9 * ci * cout
        moved = nbytes(x, lib_w, kw.get("residual")) + n * h * w * cout * 2
        library = lambda: F.conv2d(video.nchw(x), lib_w, bias, padding=1)
        if first:
            ph.time(name, run, plain, flops, moved, library, "F.conv2d alone", label)
        dev_ms, lib_ms = graph_ms(run), graph_ms(library)
        if first:
            ph.times[name]["device_ms"] = dev_ms
        b_ms, b_by = bound_ms(flops, moved)
        plan = getattr(cv, "conv3x3_plan", None)  # absent in trees before the plans
        plan = "" if plan is None else plan(n, h, w, ci, cout)
        plan = plan and (f"{plan.mainloop} bn {plan.bn} ks {plan.k_slices} "
                         f"grid {plan.grid}")
        p_ms = ph.times[name]["plain_ms"] if first else cuda_ms(plain, 3)
        log(f"  {name} {label} x{per}: {dev_ms:.4f} / {lib_ms:.4f} / {b_ms:.4f} ms ({b_by}), "
            f"{flops / dev_ms / 1e9:.1f} TFLOP/s, plain {p_ms:.4f}; {plan}")
        return dev_ms * per, lib_ms * per

    def total(path, pairs):
        k, lib = (sum(v) for v in zip(*pairs))
        sums[path] = (k, lib)
        log(f"  [{smi}] conv3x3 {path}: launches x device ms, kernel {k:.3f}, F.conv2d alone "
            f"{lib:.3f}, difference {k - lib:+.3f} ms")

    sums = {}
    log("kernels: conv3x3, UNet sites at CFG batch 28 (generate, per UNet step)")
    total("generate UNet step", [site("conv3x3", 28, *st, first=st[:5] == (40, 64, 320, 320,
                                                                         "preS+post"))
                                 for st in UNET_CONV_SITES])
    log("kernels: conv3x3, UNet sites at batch 14 (train step: forward and remat recompute)")
    total("train forward + recompute", [site("conv3x3", 14, *st[:5],
                                             st[5] * (1 if st[4] == "none" else 2))
                                        for st in UNET_CONV_SITES])
    log("kernels: conv3x3 dU in the train step's backward (batch 14)")
    total("train backward dU", [site("conv3x3_input_grad", 14, h, w, co, ci, "dU", per,
                                     first=i == 0)
                                for i, (h, w, co, ci, per) in enumerate(UNET_DGRAD_SITES)])
    log("kernels: conv3x3, VAE decoder sites (chunks of 8 frames)")
    total("VAE decode chunk", [site("conv3x3", 8, *st) for st in VAE_DECODE_SITES])
    log("kernels: conv3x3, VAE encoder sites (train encode, chunks of 8 frames)")
    total("VAE encode chunk", [site("conv3x3", 8, *st) for st in VAE_ENCODE_SITES])
    log("kernels: conv3x3, VAE encoder sites at batch 1 (generate's image encode)")
    total("VAE image encode", [site("conv3x3", 1, *st) for st in VAE_ENCODE_SITES])
    # generate: 25 CFG UNet steps, the image encode, 2 decode chunks (the
    # second has 6 frames, priced at 8); the step: forward + recompute, dU,
    # 2 encode chunks (8 and 6 frames, priced at 8)
    for path, parts in (("exact video", [(25, "generate UNet step"), (1, "VAE image encode"),
                                         (2, "VAE decode chunk")]),
                        ("train step", [(1, "train forward + recompute"),
                                        (1, "train backward dU"), (2, "VAE encode chunk")])):
        k = sum(c * sums[p][0] for c, p in parts)
        lib = sum(c * sums[p][1] for c, p in parts)
        log(f"  [{smi}] conv3x3 per {path}: launches x device ms, kernel {k:.1f} ms, F.conv2d "
            f"alone {lib:.1f} ms, difference {k - lib:+.1f} ms")
    return sums


def upsample_phase(dev, ph: KernelPhase, smi: str):
    """The upsample kernel (csrc/upsample_conv.cu: nearest 2x + 3x3 conv by
    parity) at every site of UPSAMPLE_SITES (the UNet's three at CFG batch
    28 and training batch 14, the VAE decoder's three per chunk of 8 and of
    6 frames) against its plain version within the bf16 bound, two runs the
    same bits; device ms per launch in a CUDA graph beside the materialised
    form the port ran before (nearest interpolate, then F.conv2d 3x3 at 4x
    the pixels: the library time), the four parity convs as cuDNN 2x2
    F.conv2d and the bound (the larger of 4 x 2·M·4Ci·Co / 989 TFLOP/s and
    x, the tap-summed weights and the output once / 3.35 TB/s); the plan;
    Σ launches x device ms per exact video and per train step."""
    from svd_xtend_tpu_torch.ops import upsample as up
    from svd_xtend_tpu_torch.ops import video
    from svd_xtend_tpu_torch.ops.kernels import upsample_conv as uc

    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    rn = lambda *s, sc=1.0: (torch.randn(*s, device=dev, generator=g) * sc).to(torch.bfloat16)
    log("kernels: upsample (nearest 2x + 3x3 conv, parity form) at every site; device ms "
        "kernel / interpolate + F.conv2d 3x3 / four F.conv2d 2x2 / bound; the plan")
    sums = collections.Counter()
    pads = [(1 - dj, dj, 1 - di, di) for di in (0, 1) for dj in (0, 1)]
    for n, h, w, c, per_video, per_step in UPSAMPLE_SITES:
        x = rn(n, h, w, c)
        weight, bias = rn(c, c, 3, 3, sc=(9 * c) ** -0.5), 0.1 * rn(c)
        run = lambda: uc.upsample_conv(x, weight, bias)
        plain = lambda: uc.upsample2x_conv3x3_reference(x, weight, bias)
        label = f"{(n, h, w, c)} -> {(n, 2 * h, 2 * w, c)}"
        got = run()
        ph.check("upsample_conv", got, plain(), label)
        if not torch.equal(got, run()):
            raise RuntimeError(f"upsample_conv {label}: two runs differ")
        del got
        wcl = weight.contiguous(memory_format=torch.channels_last)
        library = lambda: F.conv2d(F.interpolate(video.nchw(x), scale_factor=2.0,
                                                 mode="nearest"), wcl, bias, padding=1)
        kk = [k.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
              for k in up.tap_sums(weight, torch.bfloat16)]
        parity = lambda: [F.conv2d(F.pad(video.nchw(x), p), k) for p, k in zip(pads, kk)]
        m = n * h * w
        flops = 4 * 2 * m * 4 * c * c
        moved = nbytes(x) + 16 * c * c * 2 + 4 * m * c * 2
        first = (n, h, w, c) == (28, 20, 32, 640)
        if first:
            ph.time("upsample_conv", run, plain, flops, moved, library,
                    "interpolate + F.conv2d 3x3", label)
        dev_ms, lib_ms, par_ms = graph_ms(run), graph_ms(library), graph_ms(parity)
        ph.upsample_ms[(n, h, w, c)] = dev_ms
        if first:
            ph.times["upsample_conv"]["device_ms"] = dev_ms
        b_ms, b_by = bound_ms(flops, moved)
        plan = uc.upsample_plan(n, h, w, c, c)
        log(f"  upsample_conv {label} x{per_video} a video, x{per_step} a step: {dev_ms:.4f} / "
            f"{lib_ms:.4f} / {par_ms:.4f} / {b_ms:.4f} ms ({b_by}), {flops / dev_ms / 1e9:.1f} "
            f"TFLOP/s, {100 * b_ms / dev_ms:.1f} % of the bound; plan bn {plan.bn} ks "
            f"{plan.k_slices} grid {plan.grid}")
        for unit, k in (("video", per_video), ("step", per_step)):
            sums[(unit, "kernel")] += k * dev_ms
            sums[(unit, "interpolate + F.conv2d 3x3")] += k * lib_ms
            sums[(unit, "four F.conv2d 2x2")] += k * par_ms
        del x, kk
    for unit in ("video", "step"):
        log(f"  [{smi}] upsample per {'exact video' if unit == 'video' else 'train step'}: "
            "launches x device ms, " + ", ".join(f"{form} {ms:.3f} ms" for (u, form), ms
                                                  in sums.items() if u == unit))
    # generate's shapes in portrait (512x320, 1024x576): widths whose
    # warpgroup rows the epilogue stores in several boxes
    for n, h, w, c in PORTRAIT_UPSAMPLE_SHAPES:
        x = rn(n, h, w, c)
        weight, bias = rn(c, c, 3, 3, sc=(9 * c) ** -0.5), 0.1 * rn(c)
        plan, run = uc.upsample_plan(n, h, w, c, c), uc.store_run(w)
        label = (f"{(n, h, w, c)} portrait, W {w}: {64 // run if run < w else 1} stores a "
                 f"warpgroup, plan bn {plan.bn} ks {plan.k_slices}")
        ph.check("upsample_conv", uc.upsample_conv(x, weight, bias),
                 uc.upsample2x_conv3x3_reference(x, weight, bias), label)
        b_ms, b_by = bound_ms(4 * 2 * n * h * w * 4 * c * c,
                              nbytes(x) + 16 * c * c * 2 + 4 * n * h * w * c * 2)
        log(f"  upsample_conv {label}: {graph_ms(lambda: uc.upsample_conv(x, weight, bias)):.4f}"
            f" ms device, bound {b_ms:.4f} ms ({b_by})")
        del x


def split_phase(dev, ph: KernelPhase, smi: str):
    """The up blocks' conv1 over two sources at every UP_SPLIT_SITES site
    (CFG batch 28): the two-part GroupNorm fold (gn_fold.cu: one launch
    reading each channel vector from its part, and folding) within 1e-4 of its plain
    version, and
    conv3x3 with its two-source prologue against its plain version (the
    bf16 bound), two runs the same bits; device ms per launch in a CUDA
    graph of the split form (two-part fold + two-source conv) beside the
    materialised form it replaces (torch.cat, the fold and the conv over the
    concat) and the cat alone; Σ launches x device ms per UNet pass."""
    from svd_xtend_tpu_torch.ops.kernels import conv3x3 as cv
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn

    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    rn = lambda *s, sc=1.0: (torch.randn(*s, device=dev, generator=g) * sc).to(torch.bfloat16)
    log("kernels: the up blocks' conv1 over two sources (batch 28): device ms split form "
        "(fold + conv) / materialised (cat + fold + conv) / the cat alone")
    sums = collections.Counter()
    for (h, w, c1, c2, co), count in collections.Counter(UP_SPLIT_SITES).items():
        n, ci = 28, c1 + c2
        x, x2 = rn(n, h, w, c1) * 2 + 0.5, rn(n, h, w, c2)
        weight = rn(co, ci, 3, 3, sc=(9 * ci) ** -0.5).contiguous(
            memory_format=torch.channels_last)
        bias, post = 0.1 * rn(co), 0.5 * rn(n, co).float()
        scale, gbias = 1 + 0.1 * rn(ci).float(), 0.1 * rn(ci).float()
        label = f"{(n, h, w)} {c1} + {c2} -> {co}"
        fold = lambda: gn.group_norm_fold(x, scale, gbias, x2, groups=32, eps=1e-5)
        sc, sh = fold()
        for got, ref in zip((sc, sh), gn.group_norm_fold_reference(x, scale, gbias, x2,
                                                                    groups=32, eps=1e-5)):
            if not bool(torch.isfinite(got).all()) or not torch.allclose(got, ref, 1e-4, 1e-4):
                raise RuntimeError(f"group_norm_fold {label}: two parts off by "
                                   f"{(got - ref).abs().max().item()}")
        conv = lambda sc, sh, a, b: cv.conv3x3(a, weight, bias, pre_scale=sc, pre_shift=sh,
                                               pre_silu=True, post_shift=post, x2=b)
        got = conv(sc, sh, x, x2)
        ph.check("conv3x3", got, cv.conv3x3_fused_reference(x, weight, bias, sc, sh, post, None,
                                                            True, x2=x2), label + " two sources")
        if not torch.equal(got, conv(sc, sh, x, x2)):
            raise RuntimeError(f"conv3x3 {label} two sources: two runs differ")
        del got
        split = lambda: conv(*fold(), x, x2)

        def materialised():
            xc = torch.cat([x, x2], -1)
            return conv(*gn.group_norm_fold(xc, scale, gbias, groups=32, eps=1e-5), xc, None)

        cat = lambda: torch.cat([x, x2], -1)
        ms = {"split": graph_ms(split), "materialised": graph_ms(materialised),
              "cat": graph_ms(cat)}
        log(f"  {label} x{count} a pass: {ms['split']:.4f} / {ms['materialised']:.4f} / "
            f"{ms['cat']:.4f} ms")
        for k, v in ms.items():
            sums[k] += count * v
        del x, x2
    log(f"  [{smi}] the up blocks' norm1 fold + conv1 per CFG UNet pass: launches x device "
        f"ms, split form {sums['split']:.3f} ms, materialised {sums['materialised']:.3f} ms "
        f"(of which the cats {sums['cat']:.3f} ms)")


def flash_bshd_phase(dev, ph: KernelPhase):
    """The head-major entry point on (B, S, H, 64) at the L0 CFG shape."""
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    b, s, h = 28, 2560, 5
    q, k, v = ((torch.randn(b, s, h, 64, device=dev, generator=g)).to(torch.bfloat16)
               for _ in range(3))
    run = lambda: fa.flash_attention(q, k, v, scale=0.125)
    plain = lambda: fa.flash_attention_packed_reference(
        q.flatten(2), k.flatten(2), v.flatten(2), num_heads=h, scale=0.125).view(b, s, h, 64)
    log("kernels: flash attention, head-major (B, S, H, 64) entry point")
    ph.check("flash_attention", run(), plain(), f"{(b, s, h, 64)}")
    ph.time("flash_attention", run, plain, 4 * b * h * s * s * 64, nbytes(q, k, v, q),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                   v.transpose(1, 2), scale=0.125), "SDPA")


def probe_kernel_phase(dev, ph: KernelPhase):
    """The probe scripts' kernels against their plain versions, timed at
    the probes' first shapes."""
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
    from svd_xtend_tpu_torch.ops.kernels import flash_chain as fc
    from svd_xtend_tpu_torch.ops.kernels import flash_variants as fv
    from svd_xtend_tpu_torch.scripts import probe_int8_flash as pi8

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    rn = lambda *s: torch.randn(*s, device=dev, generator=g).to(torch.bfloat16)
    rp = lambda *s: torch.rand(*s, device=dev, generator=g).to(torch.bfloat16)
    log("kernels: flash forward softmax organisations (head-major (B*H, S, 64))")
    for bh, s_len, check_heads in [(140, 2560, 140), (280, 2304, 8), (250, 9216, 8)]:
        q, k, v = rn(bh, s_len, 64), rn(bh, s_len, 64), rn(bh, s_len, 64)
        qp, kp = rp(bh, s_len, 64), rp(bh, s_len, 64)
        by_mode = {}
        for mode in fv.MODES:
            a, b = (qp, kp) if mode == "nosoftmax" else (q, k)
            run = lambda: fv.flash_variants(a, b, v, scale=0.125, mode=mode)
            sl = slice(0, check_heads)
            ph.check("flash_variants", run()[sl],
                     fv.flash_variants_reference(a[sl], b[sl], v[sl], 0.125, mode),
                     f"{mode} {(bh, s_len, 64)} heads checked {check_heads}")
            if s_len == 2560:
                plain = lambda: fv.flash_variants_reference(a, b, v, 0.125, mode)
                # 4-D (1, B*H, S, 64): SDPA takes its flash backend only for 4-D inputs
                sdpa = lambda: F.scaled_dot_product_attention(a[None], b[None], v[None],
                                                              scale=0.125)
                flops = 4 * bh * s_len * s_len * 64
                ph.time("flash_variants", run, plain, flops, nbytes(a, b, v, a), sdpa, "SDPA",
                        f"{mode} {(bh, s_len)}")
                by_mode[mode] = dict(ph.times["flash_variants"], device_ms=graph_ms(run),
                                     sdpa_device_ms=graph_ms(sdpa))
                log(f"    device {by_mode[mode]['device_ms']:.4f} ms "
                    f"({flops / by_mode[mode]['device_ms'] / 1e9:.1f} TFLOP/s), SDPA device "
                    f"{by_mode[mode]['sdpa_device_ms']:.4f} ms")
        if by_mode:     # the entry holds base's times, and every mode's ms
            ph.times["flash_variants"] = dict(
                by_mode["base"], ms_by_mode={m: t["ms"] for m, t in by_mode.items()},
                device_ms_by_mode={m: t["device_ms"] for m, t in by_mode.items()})
        del q, k, v, qp, kp
        torch.cuda.empty_cache()

    log("kernels: head-sliced flash forward with LSE (packed (B, S, H*64))")
    for b, s_len, h in [(28, 2560, 5), (28, 640, 10)]:
        q, k, v = rn(b, s_len, h * 64), rn(b, s_len, h * 64), rn(b, s_len, h * 64)
        run = lambda: fa.flash_attention_headsliced(q, k, v, scale=0.125, num_heads=h)
        (o, lse), (ref_o, ref_lse) = run(), fa.flash_attention_fwd_reference(q, k, v, h, 0.125)
        ph.check("flash_attention_headsliced", o, ref_o, f"{(b, s_len, h * 64)} heads {h}")
        lerr = (lse - ref_lse).abs().max().item()
        log(f"  headsliced LSE {(b, s_len, h)}: max_abs_err {lerr:.3g} (bound {LSE_ATOL})")
        if not bool(torch.isfinite(lse).all()) or lerr > LSE_ATOL:
            raise RuntimeError(f"headsliced LSE error {lerr}")
        if s_len == 2560:
            heads = lambda a: a.view(b, s_len, h, 64).transpose(1, 2)
            ph.time("flash_attention_headsliced", run,
                    lambda: fa.flash_attention_fwd_reference(q, k, v, h, 0.125),
                    4 * b * h * s_len * s_len * 64, nbytes(q, k, v, q, lse),
                    lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                           scale=0.125), "SDPA")
        del q, k, v, o, ref_o

    log("kernels: QK.PV chains, bf16 and int8 with dynamic quantisation (int8: bit for bit); "
        "device ms of a 60-step launch at each probe tile, and the probe's ratio")
    ph.err["chain_int8_qd"] = 0.0
    for bq, bkm in pi8.TILES:
        q, kT, v, kTi, vi = pi8.inputs(bq, bkm, SEED)
        for n in (1, 2, 4):
            label = f"bq {bq} bkm {bkm} steps {n}"
            ph.check("chain_bf16", fc.chain_bf16(q, kT, v, n),
                     fc.chain_bf16_reference(q, kT, v, n), label)
            got, ref = fc.chain_int8_qd(q, kTi, vi, n), fc.chain_int8_qd_reference(q, kTi, vi, n)
            again = fc.chain_int8_qd(q, kTi, vi, n)     # the barrier's workspace was left at 0
            torch.cuda.synchronize()
            log(f"  chain_int8_qd {label}: bit-identical {torch.equal(got, ref)}, again "
                f"{torch.equal(again, ref)}, max |out| {ref.abs().max().item():.4g}")
            if not (torch.equal(got, ref) and torch.equal(again, ref)):
                raise RuntimeError(f"chain_int8_qd {label}: differs from its plain version by "
                                   f"{(got - ref).abs().max().item()}")
        n = pi8.N_INNER
        ops = n * 4 * bq * 64 * bkm     # dependent steps: a latency chain
        run_bf = lambda: fc.chain_bf16(q, kT, v, n)
        run_qd = lambda: fc.chain_int8_qd(q, kTi, vi, n)
        if (bq, bkm) == (1280, 1280):
            ph.time("chain_bf16", run_bf, lambda: fc.chain_bf16_reference(q, kT, v, n), ops,
                    nbytes(q, kT, v) + bq * 64 * 4, label=f"bq {bq} bkm {bkm} steps {n}")
            ph.time("chain_int8_qd", run_qd, lambda: fc.chain_int8_qd_reference(q, kTi, vi, n),
                    ops, nbytes(q, kTi, vi) + bq * 64 * 4, label=f"bq {bq} bkm {bkm} steps {n}",
                    peak=PEAK_INT8_OPS)
        bf_ms, qd_ms = cuda_ms(run_bf, 10), cuda_ms(run_qd, 10)
        log(f"  chains at (bq {bq}, bkm {bkm}), {n} steps: bf16 {bf_ms:.4f} ms, int8_qd "
            f"{qd_ms:.4f} ms; int8_qd / bf16 speed {bf_ms / qd_ms:.3f}x (the probe's rule: "
            f">= {pi8.DECISION_RATIO}x); clusters of {fc.cluster_size(bkm, fc.CLUSTER)} / "
            f"{fc.cluster_size(bkm, fc.CLUSTER_INT8)} blocks")


def probes_phase(counters):
    """The three probe scripts' main()s: the entry points at their shapes."""
    from svd_xtend_tpu_torch.scripts import (microbench_flash_headslice,
                                             microbench_flash_variants, probe_int8_flash)

    reset(counters)
    microbench_flash_headslice.main()
    microbench_flash_variants.main(["--sass"])
    probe_int8_flash.main()
    torch.cuda.synchronize()
    return read(counters, sorted(PROBE_ONLY | MHA_ONLY | {"flash_attention_fwd"}))


@contextlib.contextmanager
def materialised_forms():
    """The port's forms before the JAX package's defaults, as plain ops, for
    V2 only: the up-block resnets on torch.cat of the running features and
    the skip, and Upsample2D as nearest interpolate then its 3x3 conv."""
    from svd_xtend_tpu_torch.models import blocks, unet
    from svd_xtend_tpu_torch.ops import video

    def upsample(self, x):
        x = video.nhwc(F.interpolate(video.nchw(x), scale_factor=2.0, mode="nearest"))
        return video.nhwc(F.conv2d(video.nchw(x), self.conv.weight, self.conv.bias, padding=1))

    def up_block(self, x, skips, temb, ehs, num_frames, tokens=None, shard=None):
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips[-(i + 1)]], dim=-1), temb, num_frames, shard=shard)
            if self.attentions is not None:
                x = self.attentions[i](x, ehs, num_frames, tokens, shard)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x

    saved = blocks.Upsample2D.forward, unet.UpBlock.forward
    blocks.Upsample2D.forward, unet.UpBlock.forward = upsample, up_block
    try:
        yield
    finally:
        blocks.Upsample2D.forward, unet.UpBlock.forward = saved


class CatSpy:
    """aten.cat at the dispatcher while a UNet's up blocks' spatial resnets
    or upsamplers run (`cats`: their first inputs' shapes), and elsewhere
    (`outside`: a count, so that the spy is seen to be live)."""

    def __init__(self, unet):
        from torch.utils._python_dispatch import TorchDispatchMode

        spy = self
        self.cats, self.outside, self.depth, self.hooks = [], 0, 0, []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.overloadpacket is torch.ops.aten.cat:
                    if spy.depth:
                        spy.cats.append(tuple(args[0][0].shape))
                    else:
                        spy.outside += 1
                return func(*args, **(kwargs or {}))

        self.mode = Mode()
        for block in unet.up_blocks:
            for m in [*(r.spatial_res_block for r in block.resnets),
                      *(block.upsamplers or [])]:
                self.hooks.append(m.register_forward_pre_hook(
                    lambda *_: setattr(spy, "depth", spy.depth + 1)))
                self.hooks.append(m.register_forward_hook(
                    lambda *_: setattr(spy, "depth", spy.depth - 1)))

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        for h in self.hooks:
            h.remove()


def vae_v2_phase(dev):
    """V2 for the VAE decoder: the full-width temporal decoder on a (1, 2,
    16, 16, 4) latent, bf16 on the card with the parity upsample (the
    kernel) against f32 on the host (rel-L2 <= UNET_REL_L2_BOUND), beside
    the materialised upsample in bf16."""
    from svd_xtend_tpu_torch.core.config import VAEConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import init_random_
    from svd_xtend_tpu_torch.models.vae import AutoencoderKLTemporalDecoder

    with torch.device(dev):
        gpu = AutoencoderKLTemporalDecoder(VAEConfig())
    init_random_(gpu, torch.Generator(device=dev).manual_seed(SEED + 42))
    with torch.device("meta"):
        cpu = AutoencoderKLTemporalDecoder(VAEConfig())
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, strict=True,
                        assign=True)
    gpu = gpu.to(torch.bfloat16).eval()
    z = torch.randn(1, 2, 16, 16, 4, generator=torch.Generator().manual_seed(SEED + 43))
    with torch.no_grad():
        zb = z.to(dev, torch.bfloat16)
        got = gpu.decode(zb).float().cpu()
        with materialised_forms():
            old = gpu.decode(zb).float().cpu()
        t0 = time.time()
        ref = cpu.eval().decode(z)
        log(f"  host f32 VAE decode {time.time() - t0:.1f} s")
    rel, rel_old = (((a - ref).norm() / ref.norm()).item() for a in (got, old))
    log(f"  V2, the VAE decode (1, 2, 16, 16, 4) -> {tuple(got.shape)}: bf16 with the parity "
        f"upsample rel_l2 {rel:.4g} against host f32 (bound {UNET_REL_L2_BOUND}); with the "
        f"materialised upsample {rel_old:.4g}")
    if not bool(torch.isfinite(got).all()) or rel > UNET_REL_L2_BOUND:
        raise RuntimeError(f"VAE decode: rel_l2 {rel} above {UNET_REL_L2_BOUND}")
    portrait(dev, lambda z: gpu.decode(z.to(torch.bfloat16)), cpu.decode, (1, 2, 8), 4,
             "VAE decode", lambda lw: (lw, 2 * lw, 4 * lw))


def portrait(dev, run, ref, lead, channels, what, levels):
    """`run` (the card, bf16) against `ref` (the host, f32) on latents of
    the widths of 320- and 576-wide videos (40 and 72): widths at which the
    upsample kernel's epilogue stores a warpgroup's rows in several boxes
    (`levels(latent width)`: the upsamplers' input widths)."""
    gen = torch.Generator().manual_seed(SEED + 44)
    for lw in (40, 72):
        z = torch.randn(*lead, lw, channels, generator=gen)
        with torch.no_grad():
            got = run(z.to(dev)).float().cpu()
            want = ref(z)
        rel = ((got - want).norm() / want.norm()).item()
        log(f"  portrait: the {what} at latent {tuple(z.shape)} (upsample input widths "
            f"{', '.join(map(str, levels(lw)))}): bf16 on the card "
            f"rel_l2 {rel:.4g} against host f32 (bound {UNET_REL_L2_BOUND})")
        if not bool(torch.isfinite(got).all()) or rel > UNET_REL_L2_BOUND:
            raise RuntimeError(f"portrait {what} at latent width {lw}: rel_l2 {rel}")


def whole_unet_phase(dev):
    from svd_xtend_tpu_torch.core.config import UNetConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import init_random_
    from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel

    cfg = UNetConfig()
    with torch.device(dev):
        gpu = UNetSpatioTemporalConditionModel(cfg)
    init_random_(gpu, torch.Generator(device=dev).manual_seed(SEED + 1))
    with torch.device("meta"):
        cpu = UNetSpatioTemporalConditionModel(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, strict=True,
                        assign=True)
    gpu = gpu.to(torch.bfloat16).eval()
    cpu = cpu.eval()

    gen = torch.Generator().manual_seed(SEED + 2)
    sample = torch.randn(1, 2, 16, 16, cfg.in_channels, generator=gen)
    ehs = torch.randn(1, 1, cfg.cross_attention_dim, generator=gen)
    ids = torch.tensor([[6.0, 127.0, 0.02]])
    t = torch.tensor(0.25 * torch.log(torch.tensor(10.0)).item())
    with torch.no_grad():
        got = gpu(sample.to(dev), t, ehs.to(dev), ids.to(dev)).float().cpu()
        t0 = time.time()
        ref = cpu(sample, t, ehs, ids)
        log(f"  host f32 UNet forward {time.time() - t0:.1f} s")
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"  full-width UNet (1, 2, 16, 16, 8): rel_l2 {rel:.4g} (bound {UNET_REL_L2_BOUND}) "
        f"max_abs {(got - ref).abs().max().item():.4g} ref_std {ref.std().item():.4g}")
    if not bool(torch.isfinite(got).all()) or rel > UNET_REL_L2_BOUND:
        raise RuntimeError(f"whole-UNet phase: rel_l2 {rel} above {UNET_REL_L2_BOUND}")
    args = (sample.to(dev), t, ehs.to(dev), ids.to(dev))
    # V2: the JAX package's default forms (the split concat, the parity
    # upsample) in bf16 on the card against the f32 host UNet, beside the
    # materialised forms the port ran before, computed here with plain ops
    with torch.no_grad(), materialised_forms():
        old = gpu(*args).float().cpu()
    rel_old = ((old - ref).norm() / ref.norm()).item()
    log(f"  V2, the UNet: bf16 with the split concat and the parity upsample (the kernels) "
        f"rel_l2 {rel:.4g} against host f32; with the materialised forms (torch.cat, "
        f"interpolate + F.conv2d 3x3) {rel_old:.4g}; the two bf16 forms apart by rel_l2 "
        f"{((got - old).norm() / ref.norm()).item():.4g}")
    portrait(dev, lambda z: gpu(z, t, ehs.to(dev), ids.to(dev)), lambda z: cpu(z, t, ehs, ids),
             (1, 2, 8), cfg.in_channels, "UNet", lambda lw: (lw // 8, lw // 4, lw // 2))
    # no concat is built in the up blocks: no aten.cat inside their spatial
    # resnets or upsamplers on the card
    spy = CatSpy(gpu)
    with torch.no_grad(), spy:
        gpu(*args)
    log(f"  aten.cat in the up blocks' spatial resnets and upsamplers: {len(spy.cats)} "
        f"(elsewhere in the UNet: {spy.outside})")
    if spy.cats or not spy.outside:
        raise RuntimeError(f"up blocks built a concat {spy.cats}, or the spy saw no cat "
                           f"elsewhere ({spy.outside})")
    vae_v2_phase(dev)
    with torch.no_grad():
        full = gpu(*args)
        for depth in (1, 2, 3):
            out, deep = gpu(*args, return_deep=True, cache_depth=depth)
            shallow = gpu(*args, cached_deep=deep, cache_depth=depth)
            same = torch.equal(out, full) and torch.equal(shallow, full)
            log(f"  DeepCache split, depth {depth}: deep {tuple(deep.shape)}, "
                f"shallow(x, full(x).deep) == full(x) bit for bit: {same}")
            if not same:
                raise RuntimeError(f"DeepCache split at depth {depth}: max diff "
                                   f"{(shallow - full).abs().max().item()}")

    from svd_xtend_tpu_torch.core.config import TrainConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels
    from svd_xtend_tpu_torch.diffusion.training import TrainBatchEncodings, edm_denoising_loss
    from svd_xtend_tpu_torch.ops.kernels.dispatch import plain_versions
    from svd_xtend_tpu_torch.train.state import trainable_mask

    enc = TrainBatchEncodings(latents=torch.randn(1, 2, 16, 16, 4, generator=gen),
                              cond_latents=torch.randn(1, 16, 16, 4, generator=gen),
                              image_embeds=ehs, noise_aug=torch.tensor([0.02]))
    sigma, noise = torch.tensor([1.7]), torch.randn(1, 2, 16, 16, 4, generator=gen)
    tcfg = TrainConfig(remat_policy="none")

    def temporal_grad(unet, device):
        names = [n for n, m in trainable_mask(unet, "temporal").items() if m]
        named = dict(unet.named_parameters())
        params = [named[n] for n in names]
        unet.requires_grad_(False)
        for p in params:
            p.requires_grad_(True)
        e = TrainBatchEncodings(*(x.to(device) for x in enc))
        loss = edm_denoising_loss(SVDModels(unet, None, None), e, tcfg, sigma.to(device),
                                  noise.to(device))
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        return loss.item(), torch.cat([g.float().flatten().cpu() for g in grads])

    t0 = time.time()
    loss_ref, g_ref = temporal_grad(cpu, "cpu")
    log(f"  host f32 loss + temporal-scope gradient {time.time() - t0:.1f} s")
    loss_k, g_k = temporal_grad(gpu, dev)
    with plain_versions():
        loss_p, g_p = temporal_grad(gpu, dev)
    rel_k = ((g_k - g_ref).norm() / g_ref.norm()).item()
    rel_p = ((g_p - g_ref).norm() / g_ref.norm()).item()
    log(f"  temporal-scope gradient ({g_ref.numel()} values), loss {loss_ref:.5g} host, "
        f"{loss_k:.5g} kernels, {loss_p:.5g} plain: rel_l2 kernels {rel_k:.4g}, "
        f"bf16 plain {rel_p:.4g} (bounds {GRAD_REL_L2_BOUND}, {GRAD_PLAIN_RATIO}x plain)")
    if (not bool(torch.isfinite(g_k).all()) or rel_k >= GRAD_REL_L2_BOUND
            or rel_k > GRAD_PLAIN_RATIO * rel_p):
        raise RuntimeError(f"whole-UNet gradient: rel_l2 {rel_k} (plain {rel_p})")

    # the 'lora' scope: the gradient with respect to an adapter on every
    # attention projection, from a seeded nonzero B (while B is zero, A's
    # gradient is exactly zero), under remat "block" (the recompute must see
    # the merged weights)
    from svd_xtend_tpu_torch.models import lora as lora_lib

    g_lora = torch.Generator().manual_seed(SEED + 11)
    adapter = lora_lib.init(cpu, generator=g_lora)
    for ab in adapter.values():
        ab["b"].normal_(0.0, LORA_B_STD, generator=g_lora)
    lcfg = TrainConfig(remat_policy="block")

    def lora_grad(unet, device):
        ad = {n: {k: t.to(device).requires_grad_(True) for k, t in ab.items()}
              for n, ab in adapter.items()}
        params = [t for ab in ad.values() for t in (ab["a"], ab["b"])]
        unet.requires_grad_(False)
        e = TrainBatchEncodings(*(x.to(device) for x in enc))
        with lora_lib.merged(unet, ad):
            loss = edm_denoising_loss(SVDModels(unet, None, None), e, lcfg, sigma.to(device),
                                      noise.to(device))
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
        return loss.item(), torch.cat([g.float().flatten().cpu() for g in grads])

    t0 = time.time()
    loss_ref, g_ref = lora_grad(cpu, "cpu")
    log(f"  host f32 loss + LoRA gradient {time.time() - t0:.1f} s")
    loss_k, g_k = lora_grad(gpu, dev)
    with plain_versions():
        loss_p, g_p = lora_grad(gpu, dev)
    rel_k = ((g_k - g_ref).norm() / g_ref.norm()).item()
    rel_p = ((g_p - g_ref).norm() / g_ref.norm()).item()
    log(f"  LoRA gradient ({len(adapter)} targets, {g_ref.numel()} values, B ~ N(0, "
        f"{LORA_B_STD}²), remat block), loss {loss_ref:.5g} host, {loss_k:.5g} kernels, "
        f"{loss_p:.5g} plain: rel_l2 kernels {rel_k:.4g}, bf16 plain {rel_p:.4g} (bounds "
        f"{GRAD_REL_L2_BOUND}, {GRAD_PLAIN_RATIO}x plain)")
    if (not bool(torch.isfinite(g_k).all()) or rel_k >= GRAD_REL_L2_BOUND
            or rel_k > GRAD_PLAIN_RATIO * rel_p):
        raise RuntimeError(f"whole-UNet LoRA gradient: rel_l2 {rel_k} (plain {rel_p})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", default="",
                        help="directory for a torch.profiler table of one train step")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    smi = card()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn {torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    from svd_xtend_tpu_torch.ops.kernels import _build
    t0 = time.time()
    # each phase's header carries the seconds since the build began
    phase = lambda msg: log(f"[{time.time() - t0:.0f} s] {msg}")
    _build.library()
    log(f"build: {time.time() - t0:.1f} s -> {_build.library_path().name}")

    phase("kernels")
    ph = kernel_phases(dev)
    torch.cuda.empty_cache()
    phase("kernels: temporal resnet A and B at every site of the exact video and the train step")
    tresnet_phase(dev, ph, smi)
    torch.cuda.empty_cache()
    conv_sums = conv_phase(dev, ph, smi)
    torch.cuda.empty_cache()
    upsample_phase(dev, ph, smi)
    torch.cuda.empty_cache()
    split_phase(dev, ph, smi)
    torch.cuda.empty_cache()
    int8_ms = int8_kernel_phase(dev, ph, smi)
    torch.cuda.empty_cache()
    flash_bshd_phase(dev, ph)
    torch.cuda.empty_cache()
    probe_kernel_phase(dev, ph)
    torch.cuda.empty_cache()

    phase("whole UNet: full widths, card bf16 kernels vs host f32 plain (output, gradient)")
    whole_unet_phase(dev)
    torch.cuda.empty_cache()
    phase("int8 UNet: full widths in int8 mode, card bf16 kernels vs host f32 plain")
    int8_unet_phase(dev)
    torch.cuda.empty_cache()

    counters = kernel_counters()
    phase("generate: PipelineConfig() with full UNet/VAE/CLIP, bf16, all kernels on; then "
        "the CFG cache (k3) and DeepCache + CFG cache (n3 k3)")
    gen_launches, exact_video = generate_phase(dev, smi, counters, ph)
    torch.cuda.empty_cache()

    phase("int8: generate at PipelineConfig() with unet_quant, unet_quant + vae_quant and "
        "unet_quant + k3, beside the exact video")
    int8_launches, int8_psnrs = int8_video_phase(dev, smi, counters, int8_ms)
    torch.cuda.empty_cache()

    phase("eval: scripts/eval_approx.py's 12 modes at 512x320x14f, 25 steps, on the generate "
        "phase's models, image and noise; scripts/eval_tracklet.py reduced "
        f"({' '.join(TRACKLET_EVAL_ARGV)})")
    eval_launches = eval_approx_phase(dev, smi, counters, gen_launches, int8_launches,
                                      exact_video, int8_psnrs)
    del exact_video
    torch.cuda.empty_cache()
    eval_launches["eval_tracklet"] = eval_tracklet_phase(dev, smi, counters)
    torch.cuda.empty_cache()

    phase("train: default TrainConfig (temporal scope, 512x320x14f, batch 1, remat block)")
    train_launches = train_phase(dev, smi, counters, args.profile, ph, conv_sums)
    torch.cuda.empty_cache()

    phase("lora: TrainConfig(train_mode='lora') (rank 4, alpha 4, 512x320x14f, batch 1, remat "
        "block); export, read back, merge, an exact video; the VAE as a sharded component")
    lora_launches = lora_phase(dev, smi, counters, ph, conv_sums, gen_launches["generate"])
    torch.cuda.empty_cache()

    phase("cli: the training CLI (train/cli.py) at 512x320x14f, temporal scope, bf16, remat "
        "block, over the committed frame folder: straight, then resumed from checkpoint-2")
    cli_launches = cli_phase(dev, smi, counters, gen_launches["generate"], train_launches)
    torch.cuda.empty_cache()

    phase("parallel: the CLI over a world of one rank (NCCL): the full scope with host "
        "offload, the temporal scope with ZeRO-1")
    parallel_phase(dev, smi)
    torch.cuda.empty_cache()

    phase("frames: sequence parallelism, two gloo ranks on the one card against one rank: the "
        f"UNet's CFG pass, generate ({FRAMES_STEPS} steps) and a temporal-scope step at "
        f"512x320x14f; then 14 frames over {UNEVEN_RANKS} ranks ({UNEVEN_STEPS} steps)")
    frames_launches = frames_phase(dev, smi)
    torch.cuda.empty_cache()

    phase(f"model: tensor parallelism, {MODEL_RANKS} gloo ranks on the one card against one "
        "rank: the UNet's CFG pass (f32 plain versions, bf16 kernels beside the launch-plan "
        f"control), generate ({MODEL_STEPS} steps) and two temporal-scope steps at 512x320x14f; "
        "then a step each in the 'lora' scope, with 8-bit AdamW, host offload and a "
        "head-mixing attention processor, and one model-axis 8-bit update")
    model_launches = model_phase(dev, smi, ph)
    torch.cuda.empty_cache()

    phase("tracklet: the gated attention's flash kernels at (S, S + 16), the full-width "
        "tracklet UNet against host f32, generate with boxes (gate 0 bit-equal; exact, k3, "
        "n3+k3), the 'tracklet' step and the CLI's --train_mode tracklet")
    tracklet_kernel_phase(dev, ph)
    torch.cuda.empty_cache()
    tracklet_unet_phase(dev)
    torch.cuda.empty_cache()
    tracklet_launches = tracklet_video_phase(dev, smi, counters, ph, gen_launches)
    torch.cuda.empty_cache()
    tracklet_launches["tracklet_step"] = tracklet_train_phase(dev, smi, counters, ph, conv_sums,
                                                              train_launches)
    torch.cuda.empty_cache()
    tracklet_launches["tracklet_cli"] = tracklet_cli_phase(dev, smi, counters,
                                                           tracklet_launches["tracklet_step"])
    torch.cuda.empty_cache()

    phase("infer: the kernels at 1024x576, then python -m svd_xtend_tpu_torch.scripts.infer_svd "
        "at its defaults with boxes, a LoRA file and a tracklet file")
    infer_kernel_phase(dev, ph)
    torch.cuda.empty_cache()
    infer_launches = infer_phase(dev, smi, counters)
    torch.cuda.empty_cache()

    phase("optim8: full-scope steps with 8-bit AdamW and with bf16 gradients; int8 codes on the "
        "card against the CPU")
    optim8_launches = optim8_phase(dev, smi, counters)
    torch.cuda.empty_cache()

    phase("mha: the head-major attention entry point at the UNet's L0 shape")
    mha_launches = mha_phase(dev, counters)
    torch.cuda.empty_cache()

    phase("probes: the three probe scripts at their shapes")
    probe_launches = probes_phase(counters)
    by_path = {**gen_launches, **int8_launches, **eval_launches, "train": train_launches,
               "lora": lora_launches,
               "cli": cli_launches, **tracklet_launches, "infer": infer_launches,
               "optim8": optim8_launches, "mha": mha_launches, "probes": probe_launches,
               **frames_launches, **model_launches}

    sources = {
        "flash_attention_fwd": ("cuda", "svd_xtend_tpu_torch/csrc/flash_attention.cu",
                                "svd_xtend_tpu/ops/pallas/flash_attention.py:223"),
        "frame_attention_fwd": ("cuda", "svd_xtend_tpu_torch/csrc/temporal_attention.cu",
                                "svd_xtend_tpu/ops/pallas/temporal_attention.py:86"),
        "temporal_resnet_conv_a": ("cuda", "svd_xtend_tpu_torch/csrc/temporal_resnet.cu",
                                   "svd_xtend_tpu/ops/pallas/temporal_resnet.py:126"),
        "temporal_resnet_conv_b": ("cuda", "svd_xtend_tpu_torch/csrc/temporal_resnet.cu",
                                   "svd_xtend_tpu/ops/pallas/temporal_resnet.py:140"),
        "group_norm_silu": ("cuda", "svd_xtend_tpu_torch/csrc/group_norm.cu",
                            "svd_xtend_tpu/ops/pallas/groupnorm.py:51"),
        # the GroupNorm folds: XLA code in the JAX package, no Pallas kernel
        "group_norm_fold": ("cuda", "svd_xtend_tpu_torch/csrc/gn_fold.cu",
                            "svd_xtend_tpu/ops/pallas/groupnorm.py:274"),
        "fold_from_partials": ("cuda", "svd_xtend_tpu_torch/csrc/gn_fold.cu",
                               "svd_xtend_tpu/ops/pallas/temporal_resnet.py:240"),
        "geglu_fwd": ("cuda", "svd_xtend_tpu_torch/csrc/geglu.cu",
                      "svd_xtend_tpu/ops/pallas/geglu.py:119"),
        # the partial form of the same kernel (a model rank's inner columns)
        "geglu_partial": ("cuda", "svd_xtend_tpu_torch/csrc/geglu.cu",
                          "svd_xtend_tpu/ops/pallas/geglu.py:119"),
        "flash_attention_bwd_dq": ("cuda", "svd_xtend_tpu_torch/csrc/flash_backward.cu",
                                   "svd_xtend_tpu/ops/pallas/flash_attention.py:345"),
        "flash_attention_bwd_dkv": ("cuda", "svd_xtend_tpu_torch/csrc/flash_backward.cu",
                                    "svd_xtend_tpu/ops/pallas/flash_attention.py:395"),
        "conv3x3": ("cuda", "svd_xtend_tpu_torch/csrc/conv3x3.cu",
                    "svd_xtend_tpu/ops/pallas/conv3x3.py:46"),
        "conv3x3_input_grad": ("cuda", "svd_xtend_tpu_torch/csrc/conv3x3.cu",
                               "svd_xtend_tpu/ops/pallas/conv3x3.py:46"),
        # the parity upsample: XLA code in the JAX package, no Pallas kernel
        "upsample_conv": ("cuda", "svd_xtend_tpu_torch/csrc/upsample_conv.cu",
                          "svd_xtend_tpu/ops/upsample.py:55"),
        # the int8 W8A8 path: XLA code in the JAX package, no Pallas kernel
        "int8_quantize": ("cuda", "svd_xtend_tpu_torch/csrc/int8_quant.cu",
                          "svd_xtend_tpu/ops/quant.py:142"),
        "int8_gemm_conv": ("cuda", "svd_xtend_tpu_torch/csrc/int8_gemm.cu",
                           "svd_xtend_tpu/ops/quant.py:258"),
        "int8_gemm_dense": ("cuda", "svd_xtend_tpu_torch/csrc/int8_gemm.cu",
                            "svd_xtend_tpu/ops/quant.py:240"),
        "flash_attention": ("cuda", "svd_xtend_tpu_torch/csrc/flash_attention.cu",
                            "svd_xtend_tpu/ops/pallas/flash_attention.py:103"),
        "flash_attention_headsliced": ("cuda", "svd_xtend_tpu_torch/csrc/flash_attention.cu",
                                       "scripts/microbench_flash_headslice.py:37"),
        "flash_variants": ("cuda", "svd_xtend_tpu_torch/csrc/flash_variants.cu",
                           "scripts/microbench_flash_variants.py:44"),
        "chain_bf16": ("cuda", "svd_xtend_tpu_torch/csrc/flash_chain.cu",
                       "scripts/probe_int8_flash.py:48"),
        "chain_int8_qd": ("cuda", "svd_xtend_tpu_torch/csrc/flash_chain.cu",
                          "scripts/probe_int8_flash.py:64"),
    }
    kernels = []
    for name, (route, src, replaces) in sources.items():
        paths = {path: counts.get(name, 0) for path, counts in by_path.items()}
        kernels.append({"name": name, "route": route, "source": src, "replaces": replaces,
                        "launches": sum(paths.values()), "max_abs_err": ph.err[name],
                        **ph.times[name], "launches_by_path": paths})
    log(f"[{time.time() - t0:.0f} s] done")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def kernel_counters():
    """name -> the wrapper whose `launches` counts that kernel."""
    from svd_xtend_tpu_torch.ops.kernels import conv3x3 as cv
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
    from svd_xtend_tpu_torch.ops.kernels import flash_chain as fc
    from svd_xtend_tpu_torch.ops.kernels import flash_variants as fv
    from svd_xtend_tpu_torch.ops.kernels import geglu as gg
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
    from svd_xtend_tpu_torch.ops.kernels import int8_gemm as ig
    from svd_xtend_tpu_torch.ops.kernels import int8_quant as iq
    from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
    from svd_xtend_tpu_torch.ops.kernels.dispatch import plain_versions
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr
    from svd_xtend_tpu_torch.ops.kernels import upsample_conv as uc
    return {
        "flash_attention_fwd": fa.flash_attention_packed,
        "frame_attention_fwd": ta.frame_attention,
        "temporal_resnet_conv_a": tr.conv_a,
        "temporal_resnet_conv_b": tr.conv_b,
        "group_norm_silu": gn.group_norm_silu,
        "group_norm_fold": gn.group_norm_fold,
        "fold_from_partials": gn.fold_from_partials,
        "geglu_fwd": gg.ln_geglu_residual,
        "geglu_partial": gg.ln_geglu_partial,
        "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
        "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
        "conv3x3": cv.conv3x3,
        "conv3x3_input_grad": cv.conv3x3_input_grad,
        "upsample_conv": uc.upsample_conv,
        "int8_quantize": iq.quantize,
        "int8_gemm_conv": ig.int8_conv3x3,
        "int8_gemm_dense": ig.int8_dense,
        "flash_attention": fa.flash_attention,
        "flash_attention_headsliced": fa.flash_attention_headsliced,
        "flash_variants": fv.flash_variants,
        "chain_bf16": fc.chain_bf16,
        "chain_int8_qd": fc.chain_int8_qd,
    }


# kernels that only the train step's backward launches, the entry point
# that only the mha path calls (and the probes' arm T), and the kernels that
# only the probe scripts launch
BACKWARD_ONLY = frozenset({"flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                           "conv3x3_input_grad"})
MHA_ONLY = frozenset({"flash_attention"})
PROBE_ONLY = frozenset({"flash_attention_headsliced", "flash_variants", "chain_bf16",
                        "chain_int8_qd"})
# the kernels that only the int8 modes launch; the kernels no exact path
# launches
INT8_ONLY = frozenset({"int8_quantize", "int8_gemm_conv", "int8_gemm_dense"})
# the kernel that only a 'model' axis launches (and there in place of geglu_fwd)
MODEL_ONLY = frozenset({"geglu_partial"})
# the entry that folds given partials: no path launches it (kernel A folds
# its own partials), and read() holds every path to that
ENTRY_ONLY = frozenset({"fold_from_partials"})
OTHER_PATHS = MHA_ONLY | PROBE_ONLY | INT8_ONLY | MODEL_ONLY | ENTRY_ONLY


def reset(counters):
    for fn in counters.values():
        fn.launches = 0


def read(counters, names):
    launches = {name: counters[name].launches for name in names}
    log(f"  launches in the timed run: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the path: {missing}")
    stray = {n: counters[n].launches for n in ENTRY_ONLY if counters[n].launches}
    if stray:
        raise RuntimeError(f"entry points no path launches were launched: {stray}")
    return {**launches, **{n: 0 for n in ENTRY_ONLY}}


def unet_schedule(cfg):
    """The UNet passes of generate's steps under the JAX package's rules
    (diffusion/pipeline.py:318-450): (2 = the stacked CFG pair | 1 = the
    cond half, "full" | "shallow") per step."""
    k, n = max(1, cfg.uncond_reuse_interval), max(1, cfg.deep_cache_interval)
    passes = []
    for i in range(cfg.num_inference_steps):
        fresh_u, fresh_d = i % k == 0, i % n == 0
        if n == 1:
            passes.append((2 if fresh_u else 1, "full"))
        elif k == 1:
            passes.append((2, "full" if fresh_d else "shallow"))
        elif fresh_u:       # an uncond refresh runs the full pair even off n
            passes.append((2, "full"))
        else:
            passes.append((1, "full" if fresh_d else "shallow"))
    return passes


def conv3x3_launches(cfg):
    """conv3x3 launches of one video from the site tables: 45 per full UNet
    pass, the levels [0, depth) of it per shallow one, and the VAE's."""
    level = {40: 0, 20: 1, 10: 2, 5: 3}
    full = sum(st[5] for st in UNET_CONV_SITES)
    shallow = sum(st[5] for st in UNET_CONV_SITES if level[st[0]] < cfg.deep_cache_depth)
    unet = sum(full if kind == "full" else shallow for _, kind in unet_schedule(cfg))
    vae = (sum(st[5] for st in VAE_ENCODE_SITES)
           + -(-cfg.num_frames // cfg.decode_chunk_size) * sum(st[5] for st in VAE_DECODE_SITES))
    return unet + vae


def upsample_launches(cfg, unet_cfg=None, vae_cfg=None):
    """upsample_conv launches of one video from the code's structure: one
    per up block with an upsampler (all but the last) in a full UNet pass,
    and in a shallow (DeepCache) pass those of the up blocks it runs (the
    last deep_cache_depth); the VAE decoder's (all its up blocks but the
    last) per decode chunk."""
    from svd_xtend_tpu_torch.core.config import UNetConfig, VAEConfig
    n_up = len((unet_cfg or UNetConfig()).block_out_channels)
    full, shallow = n_up - 1, max(0, cfg.deep_cache_depth - 1)
    unet = sum(full if kind == "full" else shallow for _, kind in unet_schedule(cfg))
    chunks = -(-cfg.num_frames // cfg.decode_chunk_size)
    return unet + chunks * (len((vae_cfg or VAEConfig()).block_out_channels) - 1)


def check_upsample(path, launches, want, runs=1):
    got = launches["upsample_conv"] / runs
    log(f"  {path}: upsample_conv launches {got:g} per run; the code's structure gives {want}")
    if got != want:
        raise RuntimeError(f"{path}: upsample_conv launched {got} times a run, the structure "
                           f"gives {want}")


def fold_launches(unet_passes, encodes, decode_chunks, col):
    """The GroupNorm folds the configs imply, from the site tables: one
    group_norm_fold launch per GN-fold conv3x3 (every site whose epilogue
    starts with "preS") of `unet_passes` UNet passes, `encodes` VAE encodes
    and `decode_chunks` decode chunks; and per temporal resnet (column `col`
    of TRESNET_SITES: 4 per exact video, 5 per train step) one
    group_norm_fold (norm1). norm2's fold runs in kernel A's epilogue:
    fold_from_partials launches never."""
    pre = lambda sites: sum(st[5] for st in sites if st[4].startswith("preS"))
    spatial = (unet_passes * pre(UNET_CONV_SITES) + encodes * pre(VAE_ENCODE_SITES)
               + decode_chunks * pre(VAE_DECODE_SITES))
    temporal = sum(st[col] for st in TRESNET_SITES)
    return {"group_norm_fold": spatial + temporal, "fold_from_partials": 0}


def check_folds(path, launches, want, runs=1):
    """The fold kernels' launches per run against the site tables'."""
    got = {k: launches[k] / runs for k in want}
    log(f"  {path}: GroupNorm fold launches per run {got}; the site tables give {want}")
    if got != want:
        raise RuntimeError(f"{path}: fold launches {got}, the site tables give {want}")


def check_sites(path, tally, runs, col):
    """group_norm_silu's launches per run by (shape, silu), from a tally over
    `runs` runs, against column `col` of GN_SITES (3: per exact video, 4:
    per train step)."""
    got = {k: n / runs for k, n in tally.items()}
    want = {(st[0], st[1]): st[col] for st in GN_SITES if st[col]}
    if got != want:
        raise RuntimeError(f"{path}: group_norm_silu launches by site {got}, GN_SITES give "
                           f"{want}")


def forward_per_run(path, by_shape, runs, launches, fwd_ms, smi, unit):
    """The flash forward's launches per run by (batch, S_q, S_kv), from a
    tally over `runs` runs, held against the last run's launch count, and
    their sum of launches x the kernel phase's device ms at each shape."""
    per_run = {shape: n / runs for shape, n in sorted(by_shape.items(), reverse=True)}
    if sum(per_run.values()) != launches:
        raise RuntimeError(f"{path}: {launches} forward launches, {per_run} forward calls")
    missing = [shape for shape in per_run if shape not in fwd_ms]
    if missing:
        raise RuntimeError(f"{path}: no device time for the forward at {missing}")
    ms = sum(n * fwd_ms[shape] for shape, n in per_run.items())
    log(f"  {path}: flash_attention_fwd launches per {unit} by (batch, S_q, S_kv): {per_run}")
    log(f"  [{smi}] {path}: flash forward, launches x the kernel phase's device ms: "
        f"{ms:.3f} ms per {unit}")
    return ms


def generate_phase(dev, smi, counters, ph: KernelPhase):
    """The exact generate, then the two cache modes on the same image and
    noise; ({path: launches} of each mode's last timed run, the exact
    video). The kernel
    phase's device times per launch price the launches per video of the
    flash forward, GEGLU and the temporal resnet by shape."""
    import dataclasses

    from svd_xtend_tpu_torch.core.config import PipelineConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels, generate
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
    from svd_xtend_tpu_torch.ops.kernels import geglu as gg
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
    from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr
    from svd_xtend_tpu_torch.ops.kernels import upsample_conv as uc

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    t0 = time.time()
    models = SVDModels.create(device=dev, dtype=torch.bfloat16, generator=gen)
    torch.cuda.synchronize()
    log(f"  models built and initialised: {time.time() - t0:.1f} s")
    exact_cfg = PipelineConfig()
    image = torch.rand(1, exact_cfg.height, exact_cfg.width, 3, device=dev, generator=gen) * 2 - 1
    passes = []
    models.unet.register_forward_pre_hook(
        lambda _, args, kw: passes.append(
            (args[0].shape[0], "shallow" if kw.get("cached_deep") is not None else "full")),
        with_kwargs=True)
    runs = {"generate": exact_cfg,
            "generate_k3": dataclasses.replace(exact_cfg, uncond_reuse_interval=3),
            "generate_n3k3": dataclasses.replace(exact_cfg, deep_cache_interval=3,
                                                 uncond_reuse_interval=3)}
    launches, exact, videos = {}, None, {}
    for path, cfg in runs.items():
        t0 = time.time()
        generate(models, image, cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        log(f"  {path}: warm-up video {time.time() - t0:.2f} s")

        timed, new_segments = [], []
        with calls_by(fa, "flash_attention_fwd", BATCH_AND_LENGTHS) as by_shape, \
                calls_by(gg, "ln_geglu_residual", GEGLU_KEY) as geglu_by_shape, \
                calls_by(tr, "conv_a", SHAPE) as conv_a_by_shape, \
                calls_by(tr, "conv_b", SHAPE) as conv_b_by_shape, \
                calls_by(ta, "frame_attention", SHAPE) as frame_by_shape, \
                calls_by(gn, "group_norm_silu", GN_KEY) as gn_by_site, \
                calls_by(uc, "upsample_conv", SHAPE) as upsample_by_shape:
            for _ in range(GENERATE_TIMED):
                video = None        # the last run's video is not held through the next
                reset(counters)
                passes.clear()
                torch.cuda.reset_peak_memory_stats()
                segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
                t0 = time.time()
                video = generate(models, image, cfg,
                                 generator=torch.Generator(device=dev).manual_seed(SEED))
                torch.cuda.synchronize()
                timed.append(time.time() - t0)
                new_segments.append(torch.cuda.memory_stats().get("segment.all.allocated", 0)
                                    - segments)
        secs = sorted(timed)[len(timed) // 2]
        log(f"  {path}: timed videos {', '.join(f'{t:.3f}' for t in timed)} s; device memory "
            f"segments added during each {new_segments}")
        launches[path] = read(counters, [n for n in counters
                                         if n not in BACKWARD_ONLY | OTHER_PATHS])
        forward_per_run(path, by_shape, GENERATE_TIMED, launches[path]["flash_attention_fwd"],
                        ph.fwd_ms["generate"], smi, "video")
        price(f"{path}: geglu_fwd", geglu_by_shape, GENERATE_TIMED, ph.geglu_ms, smi, "video")
        if path == "generate":      # the exact video: the site table's launches by shape
            want = {st[:4]: st[4] for st in TRESNET_SITES if st[4]}
            for tally in (conv_a_by_shape, conv_b_by_shape):
                if {k: n / GENERATE_TIMED for k, n in tally.items()} != want:
                    raise RuntimeError(f"temporal resnet launches by shape {dict(tally)} per "
                                       f"{GENERATE_TIMED} videos, the site table gives {want}")
        for i, (name, tally) in enumerate((("temporal_resnet_conv_a", conv_a_by_shape),
                                           ("temporal_resnet_conv_b", conv_b_by_shape))):
            price(f"{path}: {name}", tally, GENERATE_TIMED,
                  {k: v[i] for k, v in ph.tresnet_ms.items()}, smi, "video")
        price(f"{path}: frame_attention_fwd", frame_by_shape, GENERATE_TIMED, ph.frame_ms, smi,
              "video")
        if path == "generate":
            check_sites(path, gn_by_site, GENERATE_TIMED, 3)
        price(f"{path}: group_norm_silu", gn_by_site, GENERATE_TIMED, ph.gn_ms, smi, "video")
        peak = torch.cuda.max_memory_allocated()
        expect = unet_schedule(cfg)
        ran = collections.Counter(passes)
        log(f"  UNet passes (batch x {cfg.num_frames} frames, kind): "
            f"{dict(sorted(ran.items()))}; the schedule's rules give "
            f"{dict(sorted(collections.Counter(expect).items()))}")
        if passes != expect:
            raise RuntimeError(f"{path}: UNet passes {passes} differ from the schedule {expect}")
        if path == "generate":      # 25 CFG passes, the image's encode, the decode chunks
            check_folds(path, launches[path], fold_launches(
                len(expect), 1, -(-cfg.num_frames // cfg.decode_chunk_size), 4))
        check_upsample(path, launches[path], upsample_launches(cfg))
        if path == "generate":      # the site table's launches by shape, and their time
            if upsample_by_shape != collections.Counter(
                    {st[:4]: st[4] * GENERATE_TIMED for st in UPSAMPLE_SITES if st[4]}):
                raise RuntimeError(f"upsample launches by shape {dict(upsample_by_shape)} per "
                                   f"{GENERATE_TIMED} videos differ from UPSAMPLE_SITES")
        price(f"{path}: upsample_conv", upsample_by_shape, GENERATE_TIMED, ph.upsample_ms,
              smi, "video")
        want = conv3x3_launches(cfg)
        log(f"  conv3x3 launches {launches[path]['conv3x3']}; the site tables give {want}")
        if launches[path]["conv3x3"] != want:
            raise RuntimeError(f"{path}: conv3x3 launched {launches[path]['conv3x3']} times, "
                               f"the site tables give {want}")

        shape = (1, cfg.num_frames, cfg.height, cfg.width, 3)
        if tuple(video.shape) != shape:
            raise RuntimeError(f"video shape {tuple(video.shape)} != {shape}")
        if not bool(torch.isfinite(video).all()):
            raise RuntimeError("video has non-finite values")
        if video.min().item() < -1.0 or video.max().item() > 1.0:
            raise RuntimeError("video outside [-1, 1]")
        dist = ""
        if exact is None:
            exact = video
        else:
            d = (video - exact).abs()
            dist = (f"; distance to the exact video max {d.max().item():.4f} mean "
                    f"{d.mean().item():.5f} (random weights: reported, not held)")
        videos[path] = video
        log(f"  video {tuple(video.shape)} finite, in [-1, 1], std {video.std().item():.4f}"
            f"{dist}")
        log(f"  [{smi}] {path}: seconds/video {secs:.3f} (median of {GENERATE_TIMED}); "
            f"frames/s {cfg.num_frames / secs:.3f}; peak allocated {peak / 2**30:.2f} GiB")
    # the evaluation utilities on the card, over the exact and the k3 video
    from svd_xtend_tpu_torch.utils.metrics import clip_fvd, video_report
    t0 = time.time()
    with torch.no_grad():
        report = {k: v.item() for k, v in video_report(models.clip, image,
                                                       videos["generate"]).items()}
        fvd = clip_fvd(models.clip, videos["generate"], videos["generate_k3"]).item()
    torch.cuda.synchronize()
    log(f"  utils.metrics on the card ({time.time() - t0:.2f} s): video_report of the exact "
        f"video {report}; clip_fvd(exact, k3) {fvd:.6g} (random weights: reported, not held; "
        "one video a set has zero covariance, so the JAX formula gives |mean difference|^2 "
        "- 2 x features x sqrt(eps))")
    if not all(math.isfinite(v) for v in (*report.values(), fvd)):
        raise RuntimeError(f"metrics: non-finite {report}, {fvd}")
    return launches, videos["generate"]


# ------------------------------------------------------------------ int8 --

INT8_CONV_KEY = lambda xq, stats, wq, *_, **__: tuple(xq.shape) + (wq.shape[0],)
# a quantise call: a QLinear input's (rows, width, code width), "conv" at a Conv3x3
INT8_QUANTISE_KEY = lambda x, *_, gate=False, **__: "conv" if x.dim() == 4 else (
    x.shape[0], x.shape[1], x.shape[1] // (2 if gate else 1))
INT8_DENSE_KEY = lambda xq, stats, wq, *_, **__: (xq.shape[0], xq.shape[1], wq.shape[0])


def _split_of(h, w, ci, co):
    """(C1, C2) of an up-block conv1 site, else None."""
    for sh, sw, c1, c2, sco in UP_SPLIT_SITES:
        if (sh, sw, c1 + c2, sco) == (h, w, ci, co):
            return c1, c2
    return None


def int8_kernel_phase(dev, ph: KernelPhase, smi: str):
    """The int8 quantise kernel and the int8 GEMM at every int8 site of the
    UNet (CFG batch 28), the VAE decoder (a chunk of 8 frames) and every
    QLinear site of a CFG pass. First the quantise's proofs: its codes
    against the IEEE division over every (bf16 v, bf16 amax) pair, its
    branch-free SiLU against the exact form over every f32 |a| <= 16, its
    GELU table (the gate) against torch's F.gelu and product over every bf16
    gate value. Then codes, (amax, scale) and outputs bit for bit against the
    plain versions on the same inputs, two runs the same bits; device ms per
    launch in a CUDA graph of the quantise and the GEMM apart (the GEMM
    under its plan, int8_gemm.int8_gemm_plan: the wgmma kernels, or the
    mma.sync kernel at the edge convs), the mma.sync kernel launched with its
    explicit plan beside it (the first version, bit for bit too), the bf16
    path at the same site (the conv3x3 kernel where it takes the site,
    F.conv2d bf16; bf16 F.linear, and torch._int_mm + the plain dequantise,
    the library time of the dense) and the bound (int8 operations at 1,979
    TOP/s against the bytes: the bf16 input read once, the int8 weights, the
    bf16 output and residual). The quantise at the QLinear inputs by
    INT8_QUANTISE_SITES (one a self-attention's q, k and v; net.2's the
    gate, beside the module path it replaces: F.gelu, the product, then the
    quantise, bit for bit the same codes). Returns {(kind, key): ms} ("conv":
    (quantise ms, GEMM ms); "dense": GEMM ms; "quantise": ms) and prints Σ
    launches x device ms per video, each GEMM's beside the mma.sync
    kernel's."""
    from svd_xtend_tpu_torch.ops import video
    from svd_xtend_tpu_torch.ops.kernels import conv3x3 as cv
    from svd_xtend_tpu_torch.ops.kernels import int8_gemm as ig
    from svd_xtend_tpu_torch.ops.kernels import int8_quant as iq

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    rn = lambda *s, sc=1.0: (torch.randn(*s, device=dev, generator=g) * sc).to(torch.bfloat16)
    ms = {}

    def same(name, got, ref, label):
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            if a.shape != b.shape or not torch.equal(a.reshape(-1), b.reshape(-1)):
                raise RuntimeError(f"{name} {label}: not the plain version's bits (max diff "
                                   f"{(a.float() - b.float()).abs().max().item()})")
        ph.err[name] = max(ph.err.get(name, 0.0), 0.0)

    bad, pairs = iq.code_selftest(dev)
    slow_bad, values = iq.silu_selftest(dev)
    gates = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(torch.bfloat16).to(dev)
    gate_bad = 0
    for h in (torch.ones_like(gates), rn(65536)):
        y = torch.cat([h, gates]).reshape(1, -1)
        got, ref = iq.gate_values(y), iq.gate_reference(y)
        nan = torch.isnan(ref)
        gate_bad += int((~((got.view(torch.int16) == ref.view(torch.int16))
                           | (nan & torch.isnan(got)))).sum())
    log(f"  int8_quantize proofs: codes against the IEEE division {bad} of {pairs} (bf16 v, "
        f"amax) pairs apart; the branch-free SiLU {slow_bad} of {values} f32 |a| <= 16 apart "
        f"from the exact form; the gate's GELU table and product {gate_bad} of 2 x 65536 bf16 "
        f"gate values apart from F.gelu(approximate='tanh') and torch's product")
    if bad or slow_bad or gate_bad:
        raise RuntimeError("int8_quantize: a proof failed")

    def conv_site(n, h, w, ci, co, epi, per, first=False):
        split = _split_of(h, w, ci, co) if "post" in epi else None
        c1 = split[0] if split else ci
        x = rn(n, h, w, c1) * 2
        x2 = rn(n, h, w, ci - c1) * 2 if split else None
        pre = ((1 + 0.2 * rn(n, ci)).float() / 2, 0.3 * rn(n, ci).float(), True) \
            if epi.startswith("preS") else None
        weight = rn(co, ci, 3, 3, sc=(9 * ci) ** -0.5).contiguous(
            memory_format=torch.channels_last)
        bias = 0.1 * rn(co)
        post = 0.5 * rn(n, co).float() if "post" in epi else None
        res = rn(n, h, w, co) if "res" in epi else None
        wq, w_amax = ig.conv_codes(weight)
        label = f"{(n, h, w, ci)} -> {co} {epi}" + (f" (two sources {split})" if split else "")
        quant = lambda: iq.quantize(x, pre, x2)
        xq, stats = quant()
        same("int8_quantize", (xq, stats), iq.quantize_reference(x, pre, x2), label)
        same("int8_quantize", (xq, stats), quant(), label + ", second run")
        gemm = lambda: ig.int8_conv3x3(xq, stats, wq, w_amax, bias, post, res)
        plan, old = ig.int8_gemm_plan(n * h * w, co, ci, 9), ig.mma_plan(n * h * w, co, ci, 9)
        mma = lambda: ig.int8_conv3x3(xq, stats, wq, w_amax, bias, post, res, plan=old)
        out = gemm()
        same("int8_gemm_conv", (out,), (ig.conv_reference(xq, stats, wq, w_amax, bias, post,
                                                          res),), label)
        same("int8_gemm_conv", (out,), (gemm(),), label + ", second run")
        same("int8_gemm_conv", (out,), (mma(),), label + ", the mma.sync kernel")
        q_ms, g_ms = graph_ms(quant), graph_ms(gemm)
        o_ms = g_ms if plan == old else graph_ms(mma)
        xs = [x] if x2 is None else [x, x2]
        ops = 2 * n * h * w * 9 * ci * co
        moved = nbytes(*xs, wq, res) + n * h * w * co * 2
        b_ms, b_by = bound_ms(ops, moved, PEAK_INT8_OPS)
        q_b, _ = bound_ms(0, nbytes(*xs, xq))
        kw = dict(pre_scale=pre[0], pre_shift=pre[1], pre_silu=True) if pre else {}
        if cv.supports(x, weight, x2, pre is not None):
            bf16 = lambda: cv.conv3x3(x, weight, bias, post_shift=post, residual=res, x2=x2, **kw)
            k_ms = f"{graph_ms(bf16):.4f}"
        else:
            k_ms = "declined"
        xin = x if x2 is None else torch.cat([x, x2], -1)
        library = lambda: F.conv2d(video.nchw(xin), weight, bias, padding=1)
        lib_ms = graph_ms(library)
        if first:
            ph.time("int8_quantize", quant, lambda: iq.quantize_reference(x, pre, x2),
                    0, nbytes(*xs, xq), label=label, peak=PEAK_INT8_OPS)
            ph.times["int8_quantize"]["device_ms"] = q_ms
            ph.time("int8_gemm_conv", gemm,
                    lambda: ig.conv_reference(xq, stats, wq, w_amax, bias, post, res),
                    ops, nbytes(xq, wq, res) + n * h * w * co * 2, label=label,
                    peak=PEAK_INT8_OPS)
            ph.times["int8_gemm_conv"].update(device_ms=g_ms, mma_device_ms=o_ms)
        g_b, _ = bound_ms(ops, nbytes(xq, wq, res) + n * h * w * co * 2, PEAK_INT8_OPS)
        log(f"  int8 conv {label} x{per}: quantise {q_ms:.4f} (its bound {q_b:.4f}, "
            f"{100 * q_b / q_ms:.1f} %) + GEMM {g_ms:.4f} = {q_ms + g_ms:.4f} ms "
            f"({ops / g_ms / 1e9:.1f} TOP/s in the GEMM, {plan_tag(plan)}; the mma.sync kernel "
            f"{o_ms:.4f}, the GEMM's bound {g_b:.4f}); bf16 conv3x3 kernel {k_ms}, F.conv2d "
            f"bf16 {lib_ms:.4f}; bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / (q_ms + g_ms):.1f} % of it")
        ms[("conv", (n, h, w, ci, co))] = (q_ms, g_ms)
        bf = float(k_ms) if k_ms != "declined" else lib_ms
        return (q_ms + g_ms) * per, bf * per, lib_ms * per, q_ms * per, g_ms * per, o_ms * per

    def dense_site(rows, k, co, per, first=False):
        x = rn(rows, k)
        weight = rn(co, k, sc=k ** -0.5)
        bias = 0.1 * rn(co)
        wq, w_amax = ig.dense_codes(weight)
        label = f"({rows}, {k}) -> {co}"
        xq, stats = iq.quantize(x)
        gemm = lambda: ig.int8_dense(xq, stats, wq, w_amax, bias)
        plan, old = ig.int8_gemm_plan(rows, co, k), ig.mma_plan(rows, co, k)
        mma = lambda: ig.int8_dense(xq, stats, wq, w_amax, bias, plan=old)
        out = gemm()
        same("int8_gemm_dense", (out,), (ig.dense_reference(xq, stats, wq, w_amax, bias),),
             label)
        same("int8_gemm_dense", (out,), (gemm(),), label + ", second run")
        same("int8_gemm_dense", (out,), (mma(),), label + ", the mma.sync kernel")
        g_ms = graph_ms(gemm)
        o_ms = g_ms if plan == old else graph_ms(mma)
        ops = 2 * rows * k * co
        # the library: cuBLASLt's int8 product (rows > 16, K and N multiples of 8)
        # and the plain dequantise
        lib = None
        if rows > 16:
            lib = lambda: _int_mm_dequant(xq, wq, stats, w_amax, bias)
            acc = torch._int_mm(xq, wq.t())
            if not torch.equal(acc, torch.matmul(xq.double(), wq.double().t()).to(torch.int32)):
                raise RuntimeError(f"torch._int_mm {label}: not the exact int32 sums")
        lib_ms = graph_ms(lib) if lib else None
        f_ms = graph_ms(lambda: F.linear(x, weight, bias))
        if first:
            ph.time("int8_gemm_dense", gemm,
                    lambda: ig.dense_reference(xq, stats, wq, w_amax, bias), ops,
                    nbytes(xq, wq) + rows * co * 2, library_fn=lib,
                    library="torch._int_mm + the plain dequantise", label=label,
                    peak=PEAK_INT8_OPS)
            ph.times["int8_gemm_dense"].update(device_ms=g_ms, mma_device_ms=o_ms)
        g_b, g_by = bound_ms(ops, nbytes(xq, wq) + rows * co * 2, PEAK_INT8_OPS)
        lib_s = f"{lib_ms:.4f}" if lib_ms is not None else "none (rows <= 16)"
        log(f"  int8 dense GEMM {label} x{per}: {g_ms:.4f} ms ({ops / g_ms / 1e9:.1f} TOP/s, "
            f"{plan_tag(plan)}; the mma.sync kernel {o_ms:.4f}; bound {g_b:.4f} ({g_by}), "
            f"{100 * g_b / g_ms:.1f} % of it); _int_mm + dequantise {lib_s}, bf16 F.linear "
            f"{f_ms:.4f}")
        ms[("dense", (rows, k, co))] = g_ms
        return g_ms * per, f_ms * per, (lib_ms or f_ms) * per, 0.0, g_ms * per, o_ms * per

    def quantise_site(rows, k_in, k, per):
        """The quantise of a QLinear input (rows, k_in) -> (rows, k) codes: at
        net.2 (k_in = 2k) the gate, beside the module path it replaces."""
        gate = k_in == 2 * k
        x = rn(rows, k_in)
        label = f"({rows}, {k_in}) -> ({rows}, {k})" + (" gate" if gate else "")
        quant = lambda: iq.quantize(x, gate=gate)
        xq, stats = quant()
        same("int8_quantize", (xq, stats), iq.quantize_reference(x, gate=gate), label)
        same("int8_quantize", (xq, stats), quant(), label + ", second run")
        q_ms = graph_ms(quant)
        b_ms, _ = bound_ms(0, nbytes(x, xq))
        module = ""
        m_ms = q_ms
        if gate:
            h, gg = x.chunk(2, dim=-1)
            path = lambda: iq.quantize(h * F.gelu(gg, approximate="tanh"))
            same("int8_quantize", (xq, stats), path(), label + ", the module path's codes")
            m_ms = graph_ms(path)
            module = (f"; the module path it replaces (F.gelu, the product, the quantise) "
                      f"{m_ms:.4f} ms, {m_ms / q_ms:.2f}x")
        log(f"  int8 quantise {label} x{per}: {q_ms:.4f} ms, bound {b_ms:.4f} "
            f"({100 * b_ms / q_ms:.1f} %){module}")
        ms[("quantise", (rows, k_in, k))] = q_ms
        return q_ms * per, m_ms * per

    def total(what, rows):
        a, b, c, q, g_, o = (sum(v) for v in zip(*rows))
        bf16 = ("the conv3x3 kernel where it takes the site, else F.conv2d" if "conv" in what
                else "F.linear")
        log(f"  [{smi}] int8 {what}: launches x device ms, int8 (quantise + GEMM) {a:.3f} "
            f"(quantise {q:.3f}, GEMM {g_:.3f}; the mma.sync kernel's GEMM {o:.3f}), "
            f"bf16 {b:.3f} ({bf16}), library {c:.3f} ms")
        return a, b, q, g_, o

    # the grid barrier's cost: one tile a block over every SM against one
    # block's tile alone (no barrier), the same work a block
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = iq.quantize_plan(sms * 16, (512,), sms=sms)
    wide, alone = rn(sms * plan.tile_rows, 512), rn(plan.tile_rows, 512)
    b_ms, a_ms = graph_ms(lambda: iq.quantize(wide)), graph_ms(lambda: iq.quantize(alone))
    log(f"  int8_quantize's grid barrier: {sms} blocks of one {plan.tile_rows}-row tile "
        f"{b_ms:.4f} ms against one block's tile alone {a_ms:.4f} ms: {b_ms - a_ms:.4f} ms")
    log("kernels: int8, every Conv3x3 of a CFG UNet pass (batch 28)")
    unet = total("convs per CFG UNet pass", [
        conv_site(28, *st, first=st[:5] == (40, 64, 320, 320, "preS+post"))
        for st in INT8_CONV_SITES])
    log("kernels: int8, every Conv3x3 of the VAE decoder (a chunk of 8 frames)")
    vae = total("convs per decode chunk", [conv_site(8, *st) for st in INT8_VAE_CONV_SITES])
    log("kernels: int8, every QLinear GEMM of a CFG UNet pass")
    dense = total("dense GEMMs per CFG UNet pass", [
        dense_site(*st, first=st[:3] == (71680, 320, 320)) for st in INT8_DENSE_SITES])
    log("kernels: int8, the quantise of every QLinear input of a CFG UNet pass")
    qd, qm = (sum(v) for v in zip(*[quantise_site(*st) for st in INT8_QUANTISE_SITES]))
    gates = [st for st in INT8_QUANTISE_SITES if st[1] == 2 * st[2]]
    qg = sum(ms[("quantise", st[:3])] * st[3] for st in gates)
    log(f"  [{smi}] int8 quantise at the QLinear inputs per CFG pass: {qd:.3f} ms (the gate "
        f"sites {qg:.3f}); with the module path at the gate sites (F.gelu, the product, the "
        f"quantise) {qm:.3f} ms")
    video = lambda i, with_vae=True: 25 * unet[i] + (2 * vae[i] if with_vae else 0)
    log(f"  [{smi}] int8 per exact-schedule video (25 CFG passes, 2 decode chunks priced at "
        f"8 frames): convs {video(0):.1f} ms against bf16 {video(1):.1f}; dense "
        f"{25 * (dense[0] + qd):.1f} ms against bf16 F.linear {25 * dense[1]:.1f}")
    log(f"  [{smi}] int8 per int8_both video (launches x device ms): int8_quantize "
        f"{video(2) + 25 * qd:.1f} ms (convs {video(2):.1f}, QLinear inputs {25 * qd:.1f}; "
        f"{video(2) + 25 * qm:.1f} with the module path at the gate sites), int8_gemm_conv "
        f"{video(3):.1f} ms (the mma.sync kernel {video(4):.1f}), int8_gemm_dense "
        f"{25 * dense[3]:.1f} ms (the mma.sync kernel {25 * dense[4]:.1f}); int8_unet (no "
        f"VAE): quantise {video(2, False) + 25 * qd:.1f}, conv GEMM {video(3, False):.1f} ms "
        f"(mma.sync {video(4, False):.1f})")
    return ms


def plan_tag(plan) -> str:
    """A GEMM plan in a log line: the kernel and its tile."""
    if plan.mainloop == "tma":
        return f"wgmma bn {plan.bn} kb {plan.k_bytes} ks {plan.k_slices}"
    return f"mma.sync bn {plan.bn}"


def _int_mm_dequant(xq, wq, stats, w_amax, bias):
    from svd_xtend_tpu_torch.ops import quant
    return quant.dequantize(torch._int_mm(xq, wq.t()), stats[0], w_amax, bias, torch.bfloat16)


class Int8SiteSpy:
    """Inside the block, every int8 site the models call (Conv3x3 and
    QLinear in int8 mode: ``int8_gemm.conv3x3_site`` / ``linear_site``) is
    also run through its plain versions (``dispatch.plain_versions``) on the
    same inputs, and the two outputs compared bit for bit: a teacher-forced
    check of each site of a real pass, free of the chaos of the whole
    pass's codes. The plain run quantises each site's input itself (a
    self-attention's to_q, to_k and to_v share the kernels' codes; net.2's
    input is the gate's, as in the kernels' run). ``calls`` and ``differ``
    count by kind, ``worst`` is the largest max-abs difference seen."""

    def __init__(self):
        self.calls = {"conv": 0, "dense": 0}
        self.differ = {"conv": 0, "dense": 0}
        self.worst = 0.0

    def _wrap(self, fn, kind):
        from svd_xtend_tpu_torch.ops.kernels.dispatch import plain_versions

        def site(*args, **kwargs):
            out = fn(*args, **kwargs)
            # the plain run quantises the site's input itself, where the
            # kernels' run may take codes shared with other sites
            plain = {k: v for k, v in kwargs.items() if k != "codes"}
            with plain_versions():
                ref = fn(*args, **plain)
            self.calls[kind] += 1
            if not torch.equal(out, ref):
                self.differ[kind] += 1
                self.worst = max(self.worst, (out.float() - ref.float()).abs().max().item())
            return out
        return site

    def __enter__(self):
        from svd_xtend_tpu_torch.ops.kernels import int8_gemm as ig
        self._saved = (ig.conv3x3_site, ig.linear_site)
        ig.conv3x3_site = self._wrap(ig.conv3x3_site, "conv")
        ig.linear_site = self._wrap(ig.linear_site, "dense")
        return self

    def __exit__(self, *exc):
        from svd_xtend_tpu_torch.ops.kernels import int8_gemm as ig
        ig.conv3x3_site, ig.linear_site = self._saved


def int8_unet_phase(dev):
    """The full-width UNet on a CFG pair (2 x 2 frames, 16x16 latent) in int8
    mode, bf16 on the card (the int8 kernels) against f32 on the host (the
    plain versions). Three checks, all of which must hold:
      - teacher-forced, per site: every int8 site of the card's pass (46
        convs, and the QLinear calls of sites.int8_dense_sites at this
        shape) bit for bit its plain version on the card on the same
        inputs (Int8SiteSpy);
      - two-sided, the quantisation's own error: the card's int8 pass
        against its exact pass within [1/r, r] x the host's int8 pass
        against the host's exact pass (r = INT8_NOISE_RATIO), so that a card
        that quantised nothing, or a different share of the network, fails;
      - the card's int8 pass against the host's (from the card's bf16
        weights) within r x a control measured here: two host int8 passes
        differing only in a rounding of the weights (f32 against their bf16
        values).
    The 5e-2 bf16 bound of the whole pass is printed beside the distance and
    is not a gate: an int8 pass is chaotic in its codes (a value moved by a
    rounding takes the next code, which moves the next quantiser's inputs),
    so bf16 on the card and f32 on the host are apart by about the
    quantisation's own error."""
    from svd_xtend_tpu_torch.core.config import UNetConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import init_random_
    from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel
    from svd_xtend_tpu_torch.ops import quant
    from svd_xtend_tpu_torch.scripts.sites import INT8_CONV_SITES, int8_dense_sites

    cfg = UNetConfig()
    with torch.device(dev):
        gpu = UNetSpatioTemporalConditionModel(cfg)
    init_random_(gpu, torch.Generator(device=dev).manual_seed(SEED + 1))
    with torch.device("meta"):
        cpu = UNetSpatioTemporalConditionModel(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, strict=True,
                        assign=True)
    gpu = gpu.to(torch.bfloat16).eval()
    cpu = cpu.eval()
    with torch.device("meta"):
        cpu16 = UNetSpatioTemporalConditionModel(cfg)
    cpu16.load_state_dict({k: v.float().cpu() for k, v in gpu.state_dict().items()},
                          strict=True, assign=True)
    cpu16 = cpu16.eval()
    gen = torch.Generator().manual_seed(SEED + 2)
    sample = torch.randn(2, 2, 16, 16, cfg.in_channels, generator=gen)
    ehs = torch.randn(2, 1, cfg.cross_attention_dim, generator=gen)
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2)
    t = torch.tensor(0.25 * torch.log(torch.tensor(10.0)).item())
    with torch.no_grad():
        with quant.quantized("int8"):
            with Int8SiteSpy() as spy:
                got = gpu(sample.to(dev), t, ehs.to(dev), ids.to(dev)).float().cpu()
            t0 = time.time()
            ref = cpu16(sample, t, ehs, ids)
            log(f"  host f32 int8 UNet forward {time.time() - t0:.1f} s")
            ref32 = cpu(sample, t, ehs, ids)
        exact = cpu(sample, t, ehs, ids)
        gexact = gpu(sample.to(dev), t, ehs.to(dev), ids.to(dev)).float().cpu()
    want = {"conv": sum(s[-1] for s in INT8_CONV_SITES),
            "dense": sum(s[-1] for s in int8_dense_sites(height=128, width=128, frames=2,
                                                         batch=2))}
    log(f"  teacher-forced sites: {spy.calls} int8 site calls in the card's pass (the site "
        f"tables at this shape: {want}); outputs differing from their plain versions on the "
        f"same inputs: {spy.differ} (largest max-abs difference {spy.worst:.4g})")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    r, control = rel(got, ref), rel(ref, ref32)
    own_host, own_card = rel(ref32, exact), rel(got, gexact)
    log(f"  full-width UNet in int8 (2, 2, 16, 16, 8): card bf16 against host f32 from the "
        f"card's weights rel_l2 {r:.4g}; against host f32 from the f32 weights "
        f"{rel(got, ref32):.4g}; the two host passes apart {control:.4g} (the control); host "
        f"int8 against host exact {own_host:.4g} (the quantisation's own error); card int8 "
        f"against card exact {own_card:.4g}; card exact against host exact "
        f"{rel(gexact, exact):.4g}")
    log(f"  the 5e-2 bound of the whole pass ({UNET_REL_L2_BOUND}, bf16's): rel_l2 {r:.4g}, "
        f"{'met' if r <= UNET_REL_L2_BOUND else 'NOT met'} (printed, not a gate)")
    ratio = own_card / own_host
    log(f"  int8 gates: sites bit for bit {not any(spy.differ.values())}, every site "
        f"{spy.calls == want}; the card's own error / the host's {ratio:.4g} in "
        f"[{1 / INT8_NOISE_RATIO:.4g}, {INT8_NOISE_RATIO}]; card against host {r:.4g} <= "
        f"{INT8_NOISE_RATIO} x the control = {INT8_NOISE_RATIO * control:.4g}")
    if any(spy.differ.values()) or spy.calls != want:
        raise RuntimeError(f"int8 UNet phase: sites {spy.calls} (tables {want}), differing "
                           f"from their plain versions {spy.differ}")
    if not bool(torch.isfinite(got).all()) or not (
            1 / INT8_NOISE_RATIO <= ratio <= INT8_NOISE_RATIO) or r > INT8_NOISE_RATIO * control:
        raise RuntimeError(f"int8 UNet phase: own error ratio {ratio} or rel_l2 {r} against "
                           f"{INT8_NOISE_RATIO} x {control}")


def int8_video_phase(dev, smi, counters, ms):
    """generate in the int8 modes at PipelineConfig() (warm-up + 1 timed
    each, the median reported) beside the exact video of the same models,
    image and noise: unet_quant, unet_quant + vae_quant, unet_quant + the CFG
    cache k3. Each mode's launches held to the site tables: the int8 GEMM's
    conv launches 46 a UNet pass (+ 30 a decode chunk under vae_quant), its
    dense launches 320 a pass (INT8_DENSE_SITES), the quantise's 302 a pass
    (INT8_QUANTIZE_CALLS: one a Conv3x3, one a self-attention's q, k and v,
    net.2's the gate; + 30 a decode chunk), GEGLU none, conv3x3 the VAE's
    alone (the encoder's 21, and the decoder's 2 x 28 without vae_quant);
    F.gelu as often as in the exact video (the int8 feed-forward's gate is
    the quantise's, not the module path's); in the unet_quant videos every
    GEMM and quantise call by shape (INT8_DENSE_SITES, INT8_CONV_SITES,
    INT8_QUANTISE_SITES), priced at the kernel phase's device ms. The int8
    video against the exact one: rel-L2 and PSNR (utils/metrics.py).
    unet_quant's Σ device time over one more, traced video beside its host
    clock. ({path: launches}, {path: PSNR to the exact video in dB})."""
    import dataclasses

    from svd_xtend_tpu_torch.core.config import PipelineConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels, generate, prepare_int8
    from svd_xtend_tpu_torch.ops.kernels import int8_gemm as ig
    from svd_xtend_tpu_torch.ops.kernels import int8_quant as iq
    from svd_xtend_tpu_torch.utils.metrics import psnr

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    models = SVDModels.create(device=dev, dtype=torch.bfloat16, generator=gen)
    exact_cfg = PipelineConfig()
    image = torch.rand(1, exact_cfg.height, exact_cfg.width, 3, device=dev, generator=gen) * 2 - 1
    torch.cuda.synchronize()
    runs = {"int8_exact_baseline": exact_cfg,
            "int8_unet": dataclasses.replace(exact_cfg, unet_quant="int8"),
            "int8_both": dataclasses.replace(exact_cfg, unet_quant="int8", vae_quant="int8"),
            "int8_unet_k3": dataclasses.replace(exact_cfg, unet_quant="int8",
                                                uncond_reuse_interval=3)}
    chunks = -(-exact_cfg.num_frames // exact_cfg.decode_chunk_size)
    enc = sum(st[5] for st in VAE_ENCODE_SITES)
    dec = sum(st[5] for st in VAE_DECODE_SITES)
    launches, videos, secs, gelus, psnrs = {}, {}, {}, {}, {}
    for path, cfg in runs.items():
        t0 = time.time()
        generate(models, image, cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        log(f"  {path}: warm-up video {time.time() - t0:.2f} s")
        timed = []
        with calls_by(ig, "int8_conv3x3", INT8_CONV_KEY) as conv_by, \
                calls_by(ig, "int8_dense", INT8_DENSE_KEY) as dense_by, \
                calls_by(iq, "quantize", INT8_QUANTISE_KEY) as quant_by, \
                calls_by(F, "gelu", lambda *_, **__: "F.gelu") as gelu_by:
            for _ in range(GENERATE_TIMED):
                video = None
                reset(counters)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                video = generate(models, image, cfg,
                                 generator=torch.Generator(device=dev).manual_seed(SEED))
                torch.cuda.synchronize()
                timed.append(time.time() - t0)
        secs[path] = sorted(timed)[len(timed) // 2]
        peak = torch.cuda.max_memory_allocated()
        names = [n for n in counters if n not in BACKWARD_ONLY | MHA_ONLY | PROBE_ONLY
                 | MODEL_ONLY | ENTRY_ONLY | ({"geglu_fwd"} if cfg.unet_quant else INT8_ONLY)]
        launches[path] = read(counters, names)
        got = {n: counters[n].launches for n in ("int8_gemm_conv", "int8_gemm_dense",
                                                 "int8_quantize", "geglu_fwd", "conv3x3")}
        passes = cfg.num_inference_steps
        if cfg.unet_quant:
            want = {"int8_gemm_conv": passes * sum(st[5] for st in INT8_CONV_SITES)
                    + (chunks * sum(st[5] for st in INT8_VAE_CONV_SITES)
                       if cfg.vae_quant else 0),
                    "int8_gemm_dense": passes * sum(st[3] for st in INT8_DENSE_SITES),
                    "geglu_fwd": 0,
                    "conv3x3": enc + (0 if cfg.vae_quant else chunks * dec)}
            want["int8_quantize"] = passes * INT8_QUANTIZE_CALLS + (
                chunks * sum(st[5] for st in INT8_VAE_CONV_SITES) if cfg.vae_quant else 0)
            log(f"  {path}: int8 launches {got}; the site tables give {want}")
            if got != want:
                raise RuntimeError(f"{path}: launches {got}, the site tables give {want}")
        gelus[path] = gelu_by["F.gelu"] / GENERATE_TIMED
        if gelus[path] != gelus["int8_exact_baseline"]:
            raise RuntimeError(f"{path}: {gelus[path]} F.gelu calls a video, the exact video "
                               f"{gelus['int8_exact_baseline']}: the int8 feed-forward's gate "
                               f"is not the quantise's")
        if path == "int8_unet":     # all CFG passes: by shape, and priced
            want_dense = collections.Counter({st[:3]: st[3] * passes * GENERATE_TIMED
                                              for st in INT8_DENSE_SITES})
            want_conv = collections.Counter()
            for st in INT8_CONV_SITES:
                want_conv[(28, *st[:4])] += st[5] * passes * GENERATE_TIMED
            want_quant = collections.Counter({st[:3]: st[3] * passes * GENERATE_TIMED
                                              for st in INT8_QUANTISE_SITES})
            want_quant["conv"] = sum(want_conv.values())
            if dense_by != want_dense or conv_by != want_conv or quant_by != want_quant:
                raise RuntimeError(f"{path}: int8 calls by shape differ from the site tables: "
                                   f"dense {dict(dense_by)}, conv {dict(conv_by)}, quantise "
                                   f"{dict(quant_by)}")
            q = sum(n / GENERATE_TIMED * ms[("quantise", k)] for k, n in quant_by.items()
                    if k != "conv")
            q += sum(n / GENERATE_TIMED * ms[("conv", k)][0] for k, n in conv_by.items())
            g = sum(n / GENERATE_TIMED * ms[("dense", k)] for k, n in dense_by.items())
            g += sum(n / GENERATE_TIMED * ms[("conv", k)][1] for k, n in conv_by.items())
            log(f"  [{smi}] {path}: int8 launches x the kernel phase's device ms per video: "
                f"quantise {q:.1f} ms, GEMMs {g:.1f} ms (quantise launches by shape held to "
                f"INT8_QUANTISE_SITES and the conv sites; F.gelu calls a video "
                f"{gelus[path]:g}, the exact video's {gelus['int8_exact_baseline']:g})")
        if not bool(torch.isfinite(video).all()) or video.abs().max().item() > 1.0:
            raise RuntimeError(f"{path}: video not finite in [-1, 1]")
        videos[path] = video
        base = videos["int8_exact_baseline"]
        cmp = ""
        if path != "int8_exact_baseline":
            rel = ((video - base).norm() / base.norm()).item()
            psnrs[path] = psnr(video, base).item()
            cmp = f"; against the exact video rel_l2 {rel:.4g}, PSNR {psnrs[path]:.2f} dB"
        log(f"  [{smi}] {path}: seconds/video {secs[path]:.3f} (median of {GENERATE_TIMED}: "
            f"{', '.join(f'{t:.3f}' for t in timed)}; exact "
            f"{secs['int8_exact_baseline']:.3f}); peak allocated {peak / 2**30:.2f} GiB{cmp}")
        if path != "int8_unet":
            continue
        busy, int8_busy = device_time(lambda: generate(
            models, image, cfg, generator=torch.Generator(device=dev).manual_seed(SEED)))
        if busy is None:
            log(f"  {path}: Σ device time not measured (the profiler recorded no device time)")
        else:
            log(f"  [{smi}] {path}: Σ device time of one traced video {busy:.1f} ms (the int8 "
                f"quantise and GEMM kernels {int8_busy:.1f} ms) beside its host clock "
                f"{1e3 * secs[path]:.1f} ms (the untraced median): the device idle "
                f"{100 * (1 - busy / (1e3 * secs[path])):.1f} % of the video")
    codes = prepare_int8(models.unet)
    log(f"  int8 weight codes held on the card while the weights are unchanged: UNet "
        f"{codes / 1e9:.3f} GB, VAE decoder {prepare_int8(models.vae.decoder) / 1e9:.3f} GB")
    return launches, psnrs


# ------------------------------------------------------------------ eval --

EVAL_ITERS = 1              # eval_approx's timed videos a mode (its default is 2)
EVAL_PSNR_DB = 0.01         # its int8 video's PSNR against the int8 phase's
# eval_tracklet cut to fit the run: 50 training steps (its default 3000),
# 4-step generations (8); every other flag its default
TRACKLET_EVAL_ARGV = ["--steps", "50", "--infer_steps", "4"]
# the denoiser probe on the card (f32, TF32 off) against the CPU from the
# same weights, draws and noise: relative to the largest MSE. Both sides are
# f32 throughout and differ only in summation order (cuBLAS / cuDNN and
# group_norm_silu's kernel against the CPU's), ~1e-6 relative a layer over
# the TINY UNet's ~40 layers; a weight that did not load, or another
# conditioning, moves an MSE by 1e-2 relative or more
TRACKLET_PROBE_REL = 1e-4
TRACKLET_SUMMARY_KEYS = ["steps", "lr", "dim", "mode", "gate_init", "batch", "denoiser_probe",
                         "train_inside_frac", "held_out_inside_frac", "steers_train",
                         "steers_held_out"]
TRACKLET_ROW_KEYS = ["true", "null", "wrong", "wrong_vs_its_own_boxes", "held_out"]


def mode_launches(cfg):
    """The launches per video the site tables give a mode: the flash
    forward's (flash_calls_per_pass over the schedule's full and shallow
    passes), the upsample's (the UNet's and the decoder's structure),
    conv3x3's (the VAE's alone under unet_quant, the decoder's int8 too
    under vae_quant) and, where no pass is shallow, the int8 GEMMs' and the
    quantise's (46 convs, 320 denses and 302 quantise calls a pass, 30
    convs a decode chunk under vae_quant)."""
    h, w = cfg.height, cfg.width
    full = sum(flash_calls_per_pass(h, w).values())
    shallow = sum(flash_calls_per_pass(h, w, depth=cfg.deep_cache_depth).values())
    schedule = unet_schedule(cfg)
    want = {"flash_attention_fwd": sum(full if kind == "full" else shallow
                                       for _, kind in schedule),
            "upsample_conv": upsample_launches(cfg)}
    chunks = -(-cfg.num_frames // cfg.decode_chunk_size)
    enc = sum(st[5] for st in VAE_ENCODE_SITES)
    dec = sum(st[5] for st in VAE_DECODE_SITES)
    if not cfg.unet_quant:
        want["conv3x3"] = conv3x3_launches(cfg)
        return want
    want["conv3x3"] = enc + (0 if cfg.vae_quant else chunks * dec)
    if all(kind == "full" for _, kind in schedule):
        vae_convs = chunks * sum(st[5] for st in INT8_VAE_CONV_SITES) if cfg.vae_quant else 0
        want.update(int8_gemm_conv=len(schedule) * sum(st[5] for st in INT8_CONV_SITES)
                    + vae_convs,
                    int8_gemm_dense=len(schedule) * sum(st[3] for st in INT8_DENSE_SITES),
                    int8_quantize=len(schedule) * INT8_QUANTIZE_CALLS + vae_convs)
    return want


def eval_approx_phase(dev, smi, counters, gen_launches, int8_launches, exact_video, int8_psnrs):
    """``scripts/eval_approx.py`` through its main() at 512x320x14f, 25 steps,
    all 12 modes (--iters EVAL_ITERS), on the generate phase's seeded
    models, image and noise. Every mode's launches (its timed video) held
    to ``mode_launches``, and the exact, k3, n3+k3 and int8 (both) modes'
    launches of every kernel to the generate and int8 phases'; the exact
    video bit for bit the generate phase's; the int8 video's PSNR to the
    exact one the int8 phase's to EVAL_PSNR_DB; every row printed.
    {"eval_<mode>": launches}."""
    import shutil

    from svd_xtend_tpu_torch import native
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels
    from svd_xtend_tpu_torch.scripts import eval_approx as ea
    from svd_xtend_tpu_torch.utils.metrics import psnr

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    models = SVDModels.create(device=dev, dtype=torch.bfloat16, generator=gen)
    image = torch.rand(1, 320, 512, 3, device=dev, generator=gen) * 2 - 1
    g = torch.Generator(device=dev).manual_seed(SEED)
    # generate's own draws from the generate phase's generator, in its order
    noise = (torch.randn(image.shape, generator=g, device=dev),
             torch.randn((1, 14, 40, 64, 4), generator=g, device=dev))
    vdir = native.BUILD_DIR.parent / "eval_approx_smoke"
    argv = ["--iters", str(EVAL_ITERS), "--videos", str(vdir), "--out", str(vdir / "table.json")]
    args = ea.parse_args(argv)
    names = {cfg: name for name, cfg in ea.build(args, models)[3]}
    launches, videos, real = {}, {}, ea.generate

    def counted(models, image, cfg, **kw):
        """Each mode's last video (its timed one) and launches."""
        reset(counters)
        video = real(models, image, cfg, **kw)
        torch.cuda.synchronize()
        launches[names[cfg]] = {n: fn.launches for n, fn in counters.items()}
        videos[names[cfg]] = video
        return video

    shutil.rmtree(vdir, ignore_errors=True)
    ea.generate = counted
    t0 = time.time()
    try:
        table = ea.main(argv, models=models, image=image, noise=noise)
    finally:
        ea.generate = real
        shutil.rmtree(vdir, ignore_errors=True)
    log(f"  [{smi}] eval_approx ({time.time() - t0:.1f} s, {len(table['modes'])} modes; "
        f"operating point {table['operating_point']}):")
    for name, row in table["modes"].items():
        log(f"    {name}: {json.dumps(row)}")
    if list(table["modes"]) != list(names.values()):
        raise RuntimeError(f"eval_approx: modes {list(table['modes'])}, expected "
                           f"{list(names.values())}")
    for name, row in table["modes"].items():
        if not all(math.isfinite(v) for v in row.values()):
            raise RuntimeError(f"eval_approx {name}: non-finite metrics {row}")
    if not torch.equal(videos["exact"], exact_video):
        d = (videos["exact"] - exact_video).abs().max().item()
        raise RuntimeError(f"eval_approx: the exact video differs from the generate phase's "
                           f"(max |d| {d})")
    log("  eval_approx: its exact video is the generate phase's bit for bit")
    got = psnr(videos["int8"], videos["exact"]).item()
    want = int8_psnrs["int8_both"]
    log(f"  eval_approx: int8 PSNR to exact {got:.4f} dB (table "
        f"{table['modes']['int8']['psnr_vs_exact_db']}); the int8 phase's both modes "
        f"{want:.4f} dB")
    if abs(got - want) > EVAL_PSNR_DB or abs(
            table["modes"]["int8"]["psnr_vs_exact_db"] - want) > EVAL_PSNR_DB:
        raise RuntimeError(f"eval_approx: int8 PSNR {got} dB, the int8 phase's {want} dB")
    twins = {"exact": gen_launches["generate"], "cfg_cache_k3": gen_launches["generate_k3"],
             "deep_n3_cfg_k3": gen_launches["generate_n3k3"], "int8": int8_launches["int8_both"]}
    for name, cfg in ((n, c) for c, n in names.items()):
        got = launches[name]
        # the kernels of the path: those the exact (or int8) video launches
        needed = twins["int8" if cfg.unet_quant else "exact"]
        missing = [n for n, c in needed.items() if c and not got[n]]
        stray = [n for n in ENTRY_ONLY if got[n]]
        if missing or stray:
            raise RuntimeError(f"eval_approx {name}: kernels never launched {missing}, "
                               f"entry points no path launches launched {stray}")
        want = mode_launches(cfg)
        if any(got[k] != v for k, v in want.items()):
            raise RuntimeError(f"eval_approx {name}: launches {got}, the site tables give "
                               f"{want}")
        if name in twins and any(got[k] != v for k, v in twins[name].items()):
            raise RuntimeError(f"eval_approx {name}: launches {got}, the same mode's in the "
                               f"generate / int8 phase {twins[name]}")
        log(f"  eval_approx {name}: launches held to the site tables {want}"
            + (" and equal to its generate / int8 phase twin's" if name in twins else ""))
    return {f"eval_{name}": {k: launches[name][k] for k in counters} for name in names.values()}


def eval_tracklet_phase(dev, smi, counters):
    """``scripts/eval_tracklet.py`` through its main() (TRACKLET_EVAL_ARGV,
    on the card): its summary in the JAX script's schema, finite, the
    run's tracklet_weights.safetensors read back onto a TINY UNet's branch;
    the kernels its TINY f32 networks launch, by kernel; then its denoiser
    probe from the run's weights on the card and on the CPU (plain
    versions), fed the same draws and noise, within TRACKLET_PROBE_REL of
    the largest MSE and the probe's rounding.
    The launches of the whole run (training, generations, probe)."""
    import shutil

    from svd_xtend_tpu_torch import native
    from svd_xtend_tpu_torch.io.safetensors_io import load_file
    from svd_xtend_tpu_torch.scripts import eval_tracklet as et
    from svd_xtend_tpu_torch.train.checkpoint import TRACKLET_FILE

    work = native.BUILD_DIR.parent / "eval_tracklet_smoke"
    shutil.rmtree(work, ignore_errors=True)
    reset(counters)
    t0 = time.time()
    try:
        out = et.main([*TRACKLET_EVAL_ARGV, "--workdir", str(work)])
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        summary, rows = out["summary"], out["per_trajectory"]
        log(f"  [{smi}] eval_tracklet ({secs:.1f} s): {json.dumps(summary)}")
        for lane, row in rows.items():
            log(f"    {lane}: {json.dumps(row)}")
        log(f"  eval_tracklet: kernel launches of the run (TINY, f32) "
            f"{ {n: c for n, c in launches.items() if c} }; none of "
            f"{sorted(n for n, c in launches.items() if not c)}")
        if list(summary) != TRACKLET_SUMMARY_KEYS or sorted(rows) != sorted(
                et.TRAIN_KINDS + et.HELD_OUT) or any(list(r) != TRACKLET_ROW_KEYS
                                                      for r in rows.values()):
            raise RuntimeError(f"eval_tracklet: not the JAX script's schema: {list(summary)}, "
                               f"{ {k: list(r) for k, r in rows.items()} }")
        probe_keys = [f"{k}@s{s:g}" for s in et.PROBE_SIGMAS
                      for k in ("noisy_right", "noisy_left", "steer_margin")] + ["steer_margin"]
        if list(summary["denoiser_probe"]) != probe_keys:
            raise RuntimeError(f"eval_tracklet: probe keys {list(summary['denoiser_probe'])}")
        flat = load_file(str(work / "run" / TRACKLET_FILE))
        if not flat or not all(bool(torch.isfinite(t.float()).all()) for t in flat.values()):
            raise RuntimeError("eval_tracklet: tracklet_weights.safetensors empty or non-finite")
        dim = int(summary["dim"])
        card_models, gates = et.load_models_and_params(str(work / "run"), dim, "cuda")
        host_models, _ = et.load_models_and_params(str(work / "run"), dim, "cpu")
        # the UNet comes from the run's files; the VAE and CLIP are drawn from
        # seed 0 on each device's generator: the host takes the card's
        for name in ("vae", "clip"):
            getattr(host_models, name).load_state_dict(getattr(card_models, name).state_dict())
        log(f"  eval_tracklet: {TRACKLET_FILE} read back ({len(flat)} tensors, {len(gates)} "
            f"gates) onto the card's and the host's TINY UNet")
        draws = et.probe_draws(host_models, summary["mode"], dim)
        ds = host_models.vae.config.downsample_factor
        noise = torch.randn((1, et.FRAMES, et.H // ds, et.W // ds,
                             host_models.vae.config.latent_channels),
                            generator=torch.Generator().manual_seed(et.PROBE_NOISE_SEED))
        lanes = ("right", "left")
        on_card = et.denoiser_probe(card_models, lanes, summary["mode"], dim,
                                    draws=type(draws)(*(None if d is None else d.to(dev)
                                                        for d in draws)),
                                    noise=noise.to(dev))
        on_host = et.denoiser_probe(host_models, lanes, summary["mode"], dim, draws=draws,
                                    noise=noise)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mses = [(row[k2], on_host[k][cl][k2]) for k, by in on_card.items()
            if isinstance(by, dict) for cl, row in by.items() for k2 in row]
    scale = max(abs(h) for _, h in mses)
    err = max(abs(c - h) for c, h in mses)
    # the probe reports its MSEs to 5 decimals: each side may round by 5e-6
    bound = TRACKLET_PROBE_REL * scale + 1e-5
    log(f"  [{smi}] eval_tracklet denoiser probe, card against host: {len(mses)} MSEs, max "
        f"|d| {err:.3g} (bound {bound:.3g}: {TRACKLET_PROBE_REL:g} x the largest MSE "
        f"{scale:.5g}, and the rounding); steer_margin@s2 {on_card['steer_margin@s2']:.6g} / "
        f"{on_host['steer_margin@s2']:.6g}, @s8 {on_card['steer_margin@s8']:.6g} / "
        f"{on_host['steer_margin@s8']:.6g}")
    if not math.isfinite(err) or err > bound:
        raise RuntimeError(f"eval_tracklet: the card's probe differs from the host's by {err}")
    return launches


def device_time(fn):
    """(Σ device ms of the kernels `fn` launches, Σ of those whose name says
    int8) from torch.profiler's device records, or (None, None) where it
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = int8 = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
        total += us
        int8 += us if "int8" in e.key else 0.0
    return (total / 1e3, int8 / 1e3) if total > 0 else (None, None)


def mha_phase(dev, counters):
    """``mha`` on (B, S, C) projections at the UNet's L0 self-attention shape
    (CFG batch 2x14 frames): the BSHD flash kernel, against impl="plain"."""
    from svd_xtend_tpu_torch.ops.attention import mha

    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    q, k, v = (torch.randn(28, 2560, 320, device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3))
    reset(counters)
    out = mha(q, k, v, num_heads=5)
    torch.cuda.synchronize()
    launches = read(counters, sorted(MHA_ONLY))
    ref = mha(q, k, v, num_heads=5, impl="plain")
    err, bound = (out.float() - ref.float()).abs().max().item(), bf16_bound(ref)
    log(f"  mha (28, 2560, 320) heads 5: max_abs_err {err:.6g} against impl='plain' "
        f"(bound {bound:.6g})")
    if not bool(torch.isfinite(out).all()) or err > bound:
        raise RuntimeError(f"mha: error {err} above bound {bound}")
    return launches


class _Tally:
    """Stands in for a module's function while counting its calls by a key
    of their arguments; reads and writes of its attributes (the launch
    counter the function keeps on itself) go to the function."""

    def __init__(self, fn, key, tally):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_key", key)
        object.__setattr__(self, "_tally", tally)

    def __call__(self, first, *args, **kwargs):
        self._tally[self._key(first, *args, **kwargs)] += 1
        return self._fn(first, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def calls_by(module, name, key):
    """While active, tallies the calls of `module.name` by key(*arguments,
    **keyword arguments). The tally stands in for the module's global, which
    its callers (and the function itself) look up at each call."""
    tally = collections.Counter()
    original = getattr(module, name)
    setattr(module, name, _Tally(original, key, tally))
    try:
        yield tally
    finally:
        setattr(module, name, original)


# a flash call's (batch, queries S_q, keys S_kv), and its (S_q, S_kv)
BATCH_AND_LENGTHS = lambda q, k, *_, **__: (q.shape[0], q.shape[1], k.shape[1])
LENGTHS = lambda q, k, *_, **__: (q.shape[1], k.shape[1])
GEGLU_KEY = lambda x, *_, **__: (x.numel() // x.shape[-1], x.shape[-1])   # GEGLU's (T, C)
SHAPE = lambda x, *_, **__: tuple(x.shape)
GN_KEY = lambda x, *_, silu=True, **__: (tuple(x.shape), silu)      # a GroupNorm site


def price(what, tally, runs, ms, smi, unit):
    """Σ launches x device ms per run from a tally over `runs` runs, by key."""
    per_run = {k: n / runs for k, n in sorted(tally.items(), reverse=True)}
    total = sum(n * ms[k] for k, n in per_run.items())
    log(f"  {what} launches per {unit} by shape: {per_run}")
    log(f"  [{smi}] {what}: launches x device ms {total:.3f} ms per {unit}")
    return total


def train_conv_launches(cfg):
    """conv3x3 and dU launches of one train step from the site tables: the
    UNet's forward and its "block" remat recompute (conv_in outside the
    blocks runs once), the VAE encode of the video's chunks and of the
    conditioning image; dU at every UNET_DGRAD_SITES shape."""
    frames = cfg.per_device_batch_size * cfg.num_frames
    encodes = -(-frames // cfg.encode_chunk_size) + 1
    unet = sum(st[5] * (1 if st[4] == "none" else 2) for st in UNET_CONV_SITES)
    return {"conv3x3": unet + encodes * sum(st[5] for st in VAE_ENCODE_SITES),
            "conv3x3_input_grad": sum(st[4] for st in UNET_DGRAD_SITES)}


def timed_steps(path, scope, step, state, batch, draws, counters, ph: KernelPhase, smi, cfg,
                conv_sums):
    """TRAIN_STEPS steps of a built train step after its warm-up, each timed
    on the host clock: every kernel of the path launched; the flash
    backward's calls by tokens S held to FLASH_BWD_SITES[scope], the
    temporal resnet's by shape to TRESNET_SITES, GroupNorm's by site to
    GN_SITES, the folds to fold_launches and conv3x3's and dU's to the site
    tables; each kernel's launches priced at the kernel phases' device ms,
    and their sum. Returns (state, launches, metrics, seconds of each step,
    peak allocated bytes)."""
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
    from svd_xtend_tpu_torch.ops.kernels import geglu as gg
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
    from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr
    from svd_xtend_tpu_torch.ops.kernels import upsample_conv as uc

    reset(counters)
    torch.cuda.reset_peak_memory_stats()
    metrics, secs = [], []
    # every flash_attention_bwd call launches the dQ and the dK/dV kernel once
    with calls_by(fa, "flash_attention_bwd", LENGTHS) as by_len, \
            calls_by(fa, "flash_attention_fwd", BATCH_AND_LENGTHS) as fwd_by_shape, \
            calls_by(gg, "ln_geglu_residual", GEGLU_KEY) as geglu_by_shape, \
            calls_by(tr, "conv_a", SHAPE) as conv_a_by_shape, \
            calls_by(ta, "frame_attention", SHAPE) as frame_by_shape, \
            calls_by(gn, "group_norm_silu", GN_KEY) as gn_by_site, \
            calls_by(uc, "upsample_conv", SHAPE) as upsample_by_shape:
        for _ in range(TRAIN_STEPS):
            t0 = time.time()
            state, m = step(state, batch, generator=draws)
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
            metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    launches = read(counters, [n for n in counters if n not in OTHER_PATHS])
    priced = {"flash_attention_fwd": forward_per_run(
        path, fwd_by_shape, TRAIN_STEPS, launches["flash_attention_fwd"] / TRAIN_STEPS,
        ph.fwd_ms["train"], smi, "step")}
    priced["geglu_fwd"] = price(f"{path}: geglu_fwd", geglu_by_shape, TRAIN_STEPS,
                                ph.geglu_ms, smi, "step")
    want = {st[:4]: st[5] for st in TRESNET_SITES if st[5]}
    if {k: n / TRAIN_STEPS for k, n in conv_a_by_shape.items()} != want:
        raise RuntimeError(f"{path}: temporal resnet launches by shape {dict(conv_a_by_shape)} "
                           f"per {TRAIN_STEPS} steps, the site table gives {want}")
    # the UNet's forward and its "block" remat recompute; the video's encode
    # chunks and the conditioning image's encode
    frames = cfg.per_device_batch_size * cfg.num_frames
    check_folds(path, launches, fold_launches(
        2, -(-frames // cfg.encode_chunk_size) + 1, 0, 5), TRAIN_STEPS)
    priced["temporal_resnet_conv_a + conv_b"] = price(
        f"{path}: temporal_resnet_conv_a + conv_b", conv_a_by_shape, TRAIN_STEPS,
        {k: sum(v) for k, v in ph.tresnet_ms.items()}, smi, "step")
    priced["frame_attention_fwd"] = price(f"{path}: frame_attention_fwd", frame_by_shape,
                                          TRAIN_STEPS, ph.frame_ms, smi, "step")
    check_sites(path, gn_by_site, TRAIN_STEPS, 4)
    priced["group_norm_silu"] = price(f"{path}: group_norm_silu", gn_by_site, TRAIN_STEPS,
                                      ph.gn_ms, smi, "step")
    # the up blocks' upsamplers in the forward and the remat recompute
    want = collections.Counter({st[:4]: st[5] * TRAIN_STEPS for st in UPSAMPLE_SITES if st[5]})
    check_upsample(path, launches, sum(st[5] for st in UPSAMPLE_SITES), TRAIN_STEPS)
    if upsample_by_shape != want:
        raise RuntimeError(f"{path}: upsample launches by shape {dict(upsample_by_shape)}, "
                           f"UPSAMPLE_SITES give {dict(want)} for {TRAIN_STEPS} steps")
    priced["upsample_conv"] = price(f"{path}: upsample_conv", upsample_by_shape, TRAIN_STEPS,
                                    ph.upsample_ms, smi, "step")
    per_step = {key: n / TRAIN_STEPS for key, n in sorted(by_len.items(), reverse=True)}
    want = FLASH_BWD_SITES[scope]
    log(f"  {path}: flash_attention_bwd calls per step by (S_q, S_kv) {per_step}; the UNet's "
        f"structure gives {want} ({sum(want.values())} a step)")
    if per_step != want:
        raise RuntimeError(f"{path}: flash backward calls per step {per_step}, the UNet's "
                           f"structure gives {want}")
    for i, name in enumerate(("flash_attention_bwd_dq", "flash_attention_bwd_dkv")):
        if sum(by_len.values()) != launches[name]:
            raise RuntimeError(f"{name}: {launches[name]} launches, {sum(by_len.values())} "
                               "backward calls")
        ms = sum(n * ph.bwd_ms[key][i] for key, n in per_step.items())
        log(f"  {path}: {name} launches per step by (S_q, S_kv): {per_step}; x the kernel "
            f"phase's device ms at each = {ms:.3f} ms per step")
    priced["flash backward pair"] = sum(n * sum(ph.bwd_ms[key])
                                        for key, n in per_step.items())
    log(f"  [{smi}] {path}: flash backward pair, kernel time per step: "
        f"{priced['flash backward pair']:.3f} ms")
    want = train_conv_launches(cfg)
    got = {k: launches[k] / TRAIN_STEPS for k in want}
    log(f"  {path}: conv3x3 and dU launches per step {got}; the site tables give {want}")
    if got != want:
        raise RuntimeError(f"{path}: conv3x3 launches per step {got}, the site tables give "
                           f"{want}")
    priced["conv3x3 + dU"] = (conv_sums["train forward + recompute"][0]
                              + conv_sums["train backward dU"][0]
                              + -(-frames // cfg.encode_chunk_size)
                              * conv_sums["VAE encode chunk"][0]
                              + conv_sums["VAE image encode"][0])
    log(f"  [{smi}] {path}: Σ launches x device ms of the hand kernels per step "
        f"{sum(priced.values()):.1f} ms ({', '.join(f'{k} {v:.1f}' for k, v in priced.items())}; "
        "conv3x3 from the conv phase's site sums, the VAE's last chunk priced at 8 frames; "
        "the folds not priced)")
    for m in metrics:
        log(f"  step: loss {m['loss']:.5g} grad_norm {m['grad_norm']:.5g} lr {m['lr']:.3g}")
        if not (torch.isfinite(torch.tensor(m["loss"])) and torch.isfinite(
                torch.tensor(m["grad_norm"]))):
            raise RuntimeError(f"{path}: non-finite train metrics {m}")
    return state, launches, metrics, secs, peak


def train_phase(dev, smi, counters, profile_dir, ph: KernelPhase, conv_sums):
    """The default train step (temporal scope), two asynchronous saves of its
    state (checkpoint_holds), then one full-scope step."""
    import dataclasses

    from svd_xtend_tpu_torch.core.config import TrainConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels
    from svd_xtend_tpu_torch.train.state import (cast_frozen_to_compute, create_train_state,
                                                 make_train_step)

    cfg = TrainConfig()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    t0 = time.time()
    models = SVDModels.create(device=dev, dtype=torch.float32, generator=gen)
    state = create_train_state(cfg, models)
    cast_frozen_to_compute(models, torch.bfloat16)
    step = make_train_step(models, cfg)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in state.params)
    log(f"  models (f32 init, then bf16) and state: {time.time() - t0:.1f} s; "
        f"{len(state.names)} trainable tensors, {n_train} values")
    batch = torch.rand(cfg.per_device_batch_size, cfg.num_frames, cfg.height, cfg.width, 3,
                       device=dev, generator=gen) * 2 - 1
    draws = torch.Generator(device=dev).manual_seed(SEED + 5)

    t0 = time.time()
    state, m = step(state, batch, generator=draws)
    torch.cuda.synchronize()
    log(f"  warm-up step: {time.time() - t0:.2f} s, loss {m['loss']:.5g}, "
        f"grad_norm {m['grad_norm']:.5g}")

    trained = set(state.names)
    named = dict(models.unet.named_parameters())
    # the copies to compare against stay on the host, out of the peak below
    before_train = [m.cpu() for m in state.params]
    before_frozen = {n: p.detach().cpu() for n, p in named.items() if n not in trained}
    state, launches, _, secs, peak = timed_steps("train", "temporal", step, state, batch, draws,
                                                 counters, ph, smi, cfg, conv_sums)
    changed = sum(not torch.equal(m.cpu(), b) for m, b in zip(state.params, before_train))
    if changed == 0:
        raise RuntimeError("no trainable weight changed")
    for n, m in zip(state.names, state.params):
        if not torch.equal(named[n], m.to(named[n].dtype)):
            raise RuntimeError(f"compute copy of {n} out of step with its master")
    moved = [n for n, b in before_frozen.items() if not torch.equal(named[n].cpu(), b)]
    if moved:
        raise RuntimeError(f"frozen weights changed: {moved[:5]}")
    log(f"  {changed}/{len(state.names)} trainable f32 masters changed, "
        f"{len(before_frozen)} frozen bit-identical")
    log(f"  [{smi}] temporal scope: seconds/step {sum(secs) / len(secs):.3f} (steps "
        f"{', '.join(f'{t:.3f}' for t in secs)}); peak allocated {peak / 2**30:.2f} GiB")
    del before_train, before_frozen

    if profile_dir:
        profile_step(step, state, batch, draws, profile_dir)
    state = checkpoint_holds(state, cfg, step, batch, draws, smi)

    del state
    torch.cuda.empty_cache()
    full_cfg = dataclasses.replace(cfg, train_mode="full")
    state = create_train_state(full_cfg, models)
    step = make_train_step(models, full_cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    state, m = step(state, batch, generator=draws)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if not torch.isfinite(torch.tensor(m["loss"])):
        raise RuntimeError(f"full scope: non-finite loss {m}")
    log(f"  [{smi}] full scope ({sum(p.numel() for p in state.params)} values): one step "
        f"{time.time() - t0:.2f} s (first of its scope), loss {m['loss']:.5g}, grad_norm "
        f"{m['grad_norm']:.5g}; peak allocated {peak / 2**30:.2f} GiB")
    return launches


def checkpoint_holds(state, cfg, step, batch, draws, smi):
    """Asynchronous saves of the temporal-scope state (train/checkpoint.py):
    two saves, each followed by a train step while its writer runs, then
    wait(); the seconds each save held the caller (the first allocates its
    pinned buffers, the second reuses them), the step's beside the writer's,
    and each file loaded back equal to the state at its save."""
    import shutil

    from svd_xtend_tpu_torch.ops.kernels import _build
    from svd_xtend_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager

    root = _build.BUILD_DIR / "ckpt_smoke"
    shutil.rmtree(root, ignore_errors=True)
    manager = CheckpointManager(str(root), total_limit=2)
    try:
        for i in (1, 2):
            want = state.params[0].cpu()
            manager.save(i, state, cfg)
            t0 = time.time()
            state, _ = step(state, batch, generator=draws)
            torch.cuda.synchronize()
            step_s = time.time() - t0
            manager.wait()
            rec = manager.saves[-1]
            got = torch.load(root / f"checkpoint-{i}" / "state" / STATE_FILE, map_location="cpu",
                             weights_only=True, mmap=True)["params"][state.names[0]]
            if not torch.equal(got, want):
                raise RuntimeError(f"asynchronous save {i}: the file is not the state at the save")
            log(f"  [{smi}] asynchronous save {i} ({rec['bytes']} bytes): held the loop "
                f"{rec['hold_seconds']:.3f} s ({'pinned buffers allocated' if i == 1 else 'buffers reused'}), "
                f"its device-to-host copies {rec['copy_seconds']:.3f} s of device time, its "
                f"writer {rec['write_seconds']:.2f} s; the train step after the save (which "
                f"waits for the copies) {step_s:.3f} s; the file holds the state at the save")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return state


def lora_phase(dev, smi, counters, ph: KernelPhase, conv_sums, exact_launches):
    """The 'lora' path: train an adapter (TrainConfig(train_mode="lora"),
    rank 4, alpha 4, 512x320x14f, batch 1, remat "block") for a warm-up and
    TRAIN_STEPS timed steps; export it, read it back and merge it into the
    UNet; one exact video from the merged UNet after a warm-up one; the VAE
    written as a sharded pipeline component and loaded into a fresh VAE.
    Returns the launches of the timed steps plus those of the timed video."""
    import tempfile

    from svd_xtend_tpu_torch.core.config import PipelineConfig, TrainConfig, VAEConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels, generate
    from svd_xtend_tpu_torch.io.convert import (load_diffusers_checkpoint, lora_from_state_dict,
                                                lora_state_dict)
    from svd_xtend_tpu_torch.io.safetensors_io import load_file, load_metadata, save_file
    from svd_xtend_tpu_torch.models import lora as lora_lib
    from svd_xtend_tpu_torch.models.vae import AutoencoderKLTemporalDecoder
    from svd_xtend_tpu_torch.train.checkpoint import export_lora_diffusers
    from svd_xtend_tpu_torch.train.state import (cast_frozen_to_compute, create_train_state,
                                                 make_train_step)

    cfg = TrainConfig(train_mode="lora")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    t0 = time.time()
    models = SVDModels.create(device=dev, dtype=torch.float32, generator=gen)
    state = create_train_state(cfg, models, generator=gen)
    cast_frozen_to_compute(models, torch.bfloat16)
    step = make_train_step(models, cfg)
    torch.cuda.synchronize()
    log(f"  models (f32 init, then bf16) and adapter: {time.time() - t0:.1f} s; "
        f"{len(state.lora)} targets, {len(state.names)} tensors, "
        f"{lora_lib.num_params(state.lora)} f32 values (rank {cfg.lora_rank}, alpha "
        f"{cfg.lora_alpha})")
    batch = torch.rand(cfg.per_device_batch_size, cfg.num_frames, cfg.height, cfg.width, 3,
                       device=dev, generator=gen) * 2 - 1
    draws = torch.Generator(device=dev).manual_seed(SEED + 10)
    t0 = time.time()
    state, m = step(state, batch, generator=draws)
    torch.cuda.synchronize()
    log(f"  warm-up step: {time.time() - t0:.2f} s, loss {m['loss']:.5g}, "
        f"grad_norm {m['grad_norm']:.5g}")
    nets = {"unet": models.unet, "vae": models.vae, "clip": models.clip}
    # host copies, out of the peak below
    frozen = {(n, k): v.cpu() for n, net in nets.items() for k, v in net.state_dict().items()}
    state, launches, _, secs, peak = timed_steps("lora", "lora", step, state, batch, draws,
                                                 counters, ph, smi, cfg, conv_sums)
    now = {n: net.state_dict() for n, net in nets.items()}
    moved = [k for k, v in frozen.items() if not torch.equal(now[k[0]][k[1]].cpu(), v)]
    if moved:
        raise RuntimeError(f"lora: base weights changed: {moved[:5]}")
    del frozen
    one_token = [n for n in state.lora if n.rsplit(".", 2)[-2:] in (["attn2", "to_q"],
                                                                    ["attn2", "to_k"])]
    zero = [n for n, ab in state.lora.items() if not ab["b"].any()]
    if not one_token or sorted(zero) != sorted(one_token):
        raise RuntimeError(f"lora: B is zero at {len(zero)} targets, the one-token "
                           f"cross-attentions' q/k are {len(one_token)}: "
                           f"{sorted(set(zero) ^ set(one_token))[:5]}")
    log(f"  every UNet, VAE and CLIP weight bit-identical; B exactly zero at the "
        f"{len(one_token)} attn2 to_q/to_k targets and nonzero at the other "
        f"{len(state.lora) - len(one_token)}")
    log(f"  [{smi}] lora scope: seconds/step median {sorted(secs)[len(secs) // 2]:.3f} (steps "
        f"{', '.join(f'{t:.3f}' for t in secs)}); peak allocated {peak / 2**30:.2f} GiB")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        path = export_lora_diffusers(state.lora, os.path.join(tmp, "lora"))
        sd, meta = load_file(path), load_metadata(path)
        secs_file = time.time() - t0
        want = {k: v.detach().cpu() for k, v in lora_state_dict(state.lora).items()}
        same = (list(sorted(sd)) == list(sorted(want)) and meta == {"format": "pt"}
                and all(sd[k].dtype == v.dtype and torch.equal(sd[k], v)
                        for k, v in want.items()))
        log(f"  {os.path.basename(path)}: {os.path.getsize(path)} bytes, {len(sd)} tensors, "
            f"written and read back in {secs_file:.2f} s, bit for bit: {same}")
        if not same:
            raise RuntimeError("lora: the exported adapter does not read back bit for bit")
    adapter = lora_from_state_dict(sd, state.lora)
    name = next(n for n in adapter if adapter[n]["b"].any())
    expect = lora_lib.merge(models.unet, {name: adapter[name]}, cfg.lora_alpha)[name]
    lora_lib.merge_(models.unet, adapter, cfg.lora_alpha)
    got = dict(models.unet.named_modules())[name].weight
    if not torch.equal(got, expect):
        raise RuntimeError(f"lora: merge_ at {name} differs from merge")
    log(f"  merge_ of the read-back adapter: {name} equals merge's weight bit for bit")
    del state, step, adapter, sd
    torch.cuda.empty_cache()

    exact = PipelineConfig()
    image = torch.rand(1, exact.height, exact.width, 3, device=dev, generator=gen) * 2 - 1
    t0 = time.time()
    generate(models, image, exact, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"  merged UNet: warm-up video {time.time() - t0:.2f} s")
    reset(counters)
    t0 = time.time()
    video = generate(models, image, exact, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    secs_video = time.time() - t0
    serve = read(counters, [n for n in counters if n not in BACKWARD_ONLY | OTHER_PATHS])
    if serve != exact_launches:
        raise RuntimeError(f"lora: the merged UNet's video launched {serve}, the exact path "
                           f"{exact_launches}")
    shape = (1, exact.num_frames, exact.height, exact.width, 3)
    if (tuple(video.shape) != shape or not bool(torch.isfinite(video).all())
            or video.min().item() < -1.0 or video.max().item() > 1.0):
        raise RuntimeError(f"lora: video {tuple(video.shape)} not finite in [-1, 1]")
    log(f"  video {tuple(video.shape)} finite, in [-1, 1], std {video.std().item():.4f}; "
        f"launches equal the exact path's")
    log(f"  [{smi}] lora: merged UNet, PipelineConfig(): seconds/video {secs_video:.3f} "
        f"(one timed video after a warm-up)")

    vae_sd = {k: v.detach() for k, v in models.vae.state_dict().items()}
    del models, video
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        comp = os.path.join(root, "vae")
        os.makedirs(comp)
        t0 = time.time()
        keys, weight_map = sorted(vae_sd), {}
        for i, part in enumerate((keys[: len(keys) // 2], keys[len(keys) // 2:])):
            shard = f"diffusion_pytorch_model-0000{i + 1}-of-00002.safetensors"
            save_file({k: vae_sd[k] for k in part}, os.path.join(comp, shard),
                      metadata={"format": "pt"})
            weight_map.update({k: shard for k in part})
        total = sum(v.numel() * v.element_size() for v in vae_sd.values())
        with open(os.path.join(comp, "diffusion_pytorch_model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
        t_write = time.time() - t0
        size = sum(os.path.getsize(os.path.join(comp, f)) for f in os.listdir(comp))
        with torch.device(dev):
            fresh = AutoencoderKLTemporalDecoder(VAEConfig()).to(torch.bfloat16).eval()
        t0 = time.time()
        load_diffusers_checkpoint(root, SVDModels(None, fresh, None), components=("vae",))
        torch.cuda.synchronize()
        t_read = time.time() - t0
    loaded = fresh.state_dict()
    bad = [k for k, v in vae_sd.items()
           if loaded[k].dtype != v.dtype or not torch.equal(loaded[k], v)]
    if bad or set(loaded) != set(vae_sd):
        raise RuntimeError(f"lora: the sharded VAE did not load bit for bit: {bad[:5]}")
    log(f"  [{smi}] files: the VAE ({len(vae_sd)} tensors, {total} bytes of bf16) as a diffusers "
        f"component in 2 shards + index ({size} bytes on disk): written in {t_write:.2f} s, "
        f"loaded into a fresh VAE on the card in {t_read:.2f} s, every tensor bit for bit; "
        "directory removed")
    return {k: launches.get(k, 0) + serve.get(k, 0) for k in launches}


# ------------------------------------------------------------- the cli path --

CLI_STEPS = 4
# the reference's BDD100K run (README.md:42-54) against this phase's
CLI_REDUCED = ("max_train_steps 50000 -> 4, checkpointing_steps 1000 -> 2, "
               "validation_steps 200 -> 4; widths, frames, scope, precision, lr unchanged")


def toolchain() -> dict:
    """What the machine has for decoding and reading images: g++, libjpeg
    (header, library), nvJPEG (header, library), PIL, cv2, imageio."""
    import importlib.util
    import shutil
    import subprocess

    def run(cmd, stdin=""):
        try:
            p = subprocess.run(cmd, input=stdin, capture_output=True, text=True, timeout=60)
            return p.returncode, p.stdout
        except OSError:
            return -1, ""

    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    gxx = shutil.which("g++")
    libs = run(["ldconfig", "-p"])[1]
    have = {
        "g++": run(["g++", "--version"])[1].splitlines()[0] if gxx else None,
        "jpeglib.h": gxx is not None and run(["g++", "-E", "-x", "c++", "-"],
                                             "#include <jpeglib.h>\n")[0] == 0,
        "libjpeg.so": "libjpeg.so" in libs,
        "nvjpeg.h": os.path.exists(os.path.join(cuda, "include", "nvjpeg.h")),
        "libnvjpeg.so": os.path.exists(os.path.join(cuda, "lib64", "libnvjpeg.so")),
    }
    for mod in ("PIL", "cv2", "imageio"):
        have[mod] = importlib.util.find_spec(mod) is not None
    return have


def compare_states(a: dict, b: dict) -> dict:
    """Max abs difference of two checkpoints' state files by part: the f32
    masters, both AdamW moments, and whether the counts agree."""
    def maxdiff(xs, ys):
        return max(((x.float() - y.float()).abs().max().item() for x, y in zip(xs, ys)),
                   default=0.0)
    sa, sb = a["optimizer"]["adamw"]["state"], b["optimizer"]["adamw"]["state"]
    return {"masters": maxdiff(a["params"].values(), b["params"].values()),
            "exp_avg": maxdiff([s["exp_avg"] for s in sa.values()],
                               [sb[i]["exp_avg"] for i in sa]),
            "exp_avg_sq": maxdiff([s["exp_avg_sq"] for s in sa.values()],
                                  [sb[i]["exp_avg_sq"] for i in sa]),
            "adamw_step": maxdiff([s["step"] for s in sa.values()], [sb[i]["step"] for i in sa]),
            "same_names": list(a["params"]) == list(b["params"]),
            "count": (a["optimizer"]["count"], b["optimizer"]["count"]),
            "step": (a["step"], b["step"])}


class HostPeak:
    """The process's resident host memory sampled every 20 ms in a thread
    while active: `start` bytes, and `peak` bytes above it."""

    def _rss(self) -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def __enter__(self):
        import threading
        self.start, self.peak, self._stop = self._rss(), 0, threading.Event()

        def sample():
            while not self._stop.wait(0.02):
                self.peak = max(self.peak, self._rss() - self.start)

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss() - self.start)


def cli_phase(dev, smi, counters, exact_launches, train_launches):
    """The training CLI (train/cli.py) at full width through main(), in
    process: the native frame loader built from the checkout, its decode of
    the committed window against the JAX package's committed output; run A
    (4 straight steps, checkpoints at 2 and 4, validation at 1 and 4), run B
    (checkpoint-2 copied into a fresh directory, resumed to 4): the states at
    step 4 bit for bit (else a second straight run bounds the difference);
    the launches per train step held to the train phase's, each validation
    video's to the exact video's; the files; the loader's, checkpoints' and
    validation's times. Returns run A's launches."""
    import shutil

    import numpy as np

    from svd_xtend_tpu_torch import native
    from svd_xtend_tpu_torch.data import make_fixtures as fx
    from svd_xtend_tpu_torch.core.config import UNetConfig
    from svd_xtend_tpu_torch.io.safetensors_io import load_file
    from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel
    from svd_xtend_tpu_torch.train import cli
    from svd_xtend_tpu_torch.train.checkpoint import STATE_FILE

    t_phase = time.time()
    have = toolchain()
    log(f"  toolchain: {have}")
    t0 = time.time()
    lib = native.library()
    if not lib._name.startswith(str(native.BUILD_DIR) + os.sep):
        raise RuntimeError(f"native loader built at {lib._name}, not under {native.BUILD_DIR}")
    decoder = native.decoder()
    log(f"  native frame loader: {native.version()}, built in {time.time() - t0:.1f} s -> "
        f"{lib._name}")
    ref = np.load(fx.REFERENCE)
    t0 = time.time()
    got = native.load_clip(fx.reference_paths(), fx.REF_WIDTH, fx.REF_HEIGHT)
    secs = time.time() - t0
    if got is None or got.shape != ref.shape:
        raise RuntimeError(f"native decode of the committed window failed ({decoder})")
    err = float(np.abs(got - ref).max())
    log(f"  decode: decoder {decoder}; the committed window ({fx.REF_FRAMES} frames of "
        f"1280x720 -> {fx.REF_WIDTH}x{fx.REF_HEIGHT}) in {secs:.3f} s; max abs error against "
        f"the JAX package's native output {err:.6g} (bound 0)")
    if err != 0.0:
        raise RuntimeError(f"decode: max abs error {err}, the JAX package's output is the bits")

    root = native.BUILD_DIR.parent / "cli_smoke"
    shutil.rmtree(root, ignore_errors=True)
    val_launches = []
    original = cli.run_validation

    def counted_validation(*args, **kwargs):
        before = {n: fn.launches for n, fn in counters.items()}
        t0 = time.time()
        original(*args, **kwargs)
        torch.cuda.synchronize()
        val_launches.append({n: fn.launches - before[n] for n, fn in counters.items()})
        log(f"  validation at step {args[4]}: {time.time() - t0:.2f} s")

    def argv(out, *extra):
        return ["--base_folder", fx.FRAMES, "--train_mode", "temporal",
                "--mixed_precision", "bf16", "--learning_rate", "1e-5",
                "--lr_scheduler", "constant", "--max_train_steps", str(CLI_STEPS),
                "--checkpointing_steps", "2", "--checkpoints_total_limit", "2",
                "--validation_steps", "4", "--num_validation_images", "1", "--seed", "123",
                "--output_dir", out, *extra]

    def run(name, out, *extra):
        val_launches.clear()
        reset(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with HostPeak() as host:
            stats = cli.main(argv(out, *extra))
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = read(counters, [n for n in counters if n not in OTHER_PATHS])
        steps = len(stats["step_seconds"])
        per_step = {n: (c - sum(v[n] for v in val_launches)) / steps for n, c in launches.items()}
        want_step = {n: c / TRAIN_STEPS for n, c in train_launches.items()}
        if per_step != want_step:
            raise RuntimeError(f"cli {name}: launches per train step {per_step}, the train "
                               f"phase's {want_step}")
        for v in val_launches:
            got = {n: v[n] for n in exact_launches}
            if got != exact_launches or any(v[n] for n in v if n not in exact_launches):
                raise RuntimeError(f"cli {name}: validation video launches {v}, the exact "
                                   f"video's {exact_launches}")
        log(f"  cli {name}: {wall:.1f} s in main(); launches per train step equal the train "
            f"phase's ({sum(want_step.values()):.0f} a step), each of {len(val_launches)} "
            "validation videos' equal the exact video's")
        with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        train = [r for r in records if "train_loss" in r]
        val = [r for r in records if "val/clip_frame_score" in r]
        for r in train:
            if not all(math.isfinite(r[k]) for k in ("train_loss", "grad_norm", "lr")):
                raise RuntimeError(f"cli {name}: non-finite metrics {r}")
        wait, batch = stats["loader_wait_seconds"], stats["loader_batch_seconds"]
        log(f"  [{smi}] cli {name}: s/step from metrics.jsonl's steps_per_sec "
            f"{', '.join(f'step {r['step']}: {1 / r['steps_per_sec']:.3f}' for r in train)} (the "
            f"first step of the process, warm-up included); host s of each step (next() to "
            f"the metrics) {', '.join(f'{s:.3f}' for s in stats['step_seconds'])}")
        log(f"  [{smi}] cli {name}: loader host s per batch {', '.join(f'{s:.3f}' for s in batch)}"
            f" ({stats['decoder']}); next() blocked the loop {', '.join(f'{s:.4f}' for s in wait)}"
            " s")
        secs = stats["step_seconds"]
        start = CLI_STEPS - len(secs)        # the step of secs[0]
        for c in stats["checkpoints"]:
            # the step after an asynchronous save waits on the device for
            # its copies: its host time beside the median of the run's
            # other steps but the first (warm-up included)
            after = c["step"] - start
            others = [t for i, t in enumerate(secs) if i not in (0, after)]
            delta = (f"the step after it {secs[after]:.3f} s against a median "
                     f"{statistics.median(others):.3f} s of the others but the first"
                     if after < len(secs) and others else "no step after it")
            log(f"  [{smi}] cli {name}: checkpoint-{c['step']} {c['bytes']} bytes: the save held "
                f"the loop {c['hold_seconds']:.3f} s, the snapshot's device-to-host copies "
                f"took {c['copy_seconds']:.3f} s of device time ({delta}), its writer thread "
                f"wrote for {c['write_seconds']:.2f} s; the snapshot in pinned host memory "
                f"{c['snapshot_bytes']} bytes")
        log(f"  [{smi}] cli {name}: the process's resident host memory peaked "
            f"{host.peak / 2**30:.2f} GiB above its start ({host.start / 2**30:.2f} GiB), "
            "snapshot buffers and writer included")
        if stats["restore_seconds"] is not None:
            log(f"  [{smi}] cli {name}: restore (load + copy onto the card) "
                f"{stats['restore_seconds']:.2f} s")
        log(f"  [{smi}] cli {name}: validation s {', '.join(f'{s:.2f}' for s in stats['validation_seconds'])};"
            f" export {stats['export_seconds']:.2f} s; peak allocated {peak / 2**30:.2f} GiB")
        for r in val:
            log(f"  [{smi}] cli {name}: step {r['step']} "
                + ", ".join(f"{k} {r[k]:.6g}" for k in sorted(r) if k.startswith("val/")))
        return stats, launches

    cli.run_validation = counted_validation
    try:
        log(f"  reduced: {CLI_REDUCED}")
        a, b = str(root / "a"), str(root / "b")
        _, launches = run("A (straight, steps 0-4)", a)
        for f in ("params_freeze.txt", "params_train.txt", "logs/metrics.jsonl",
                  "validation_images/val_img_4.gif", "unet/diffusion_pytorch_model.safetensors"):
            if not os.path.isfile(os.path.join(a, f)):
                raise RuntimeError(f"cli: run A wrote no {f}")
        from PIL import Image
        with Image.open(os.path.join(a, "validation_images", "val_img_4.gif")) as gif:
            version, (w, h), n = gif.info.get("version", b"").decode(), gif.size, gif.n_frames
        if (version, w, h, n) != ("GIF89a", 512, 320, 14):
            raise RuntimeError(f"cli: val_img_4.gif is {version} {w}x{h} with {n} frames")
        t0 = time.time()
        sd = load_file(os.path.join(a, "unet", "diffusion_pytorch_model.safetensors"))
        with torch.device("meta"):
            unet = UNetSpatioTemporalConditionModel(UNetConfig())
        unet.load_state_dict(sd, strict=True, assign=True)
        dtypes = {str(t.dtype) for t in sd.values()}
        log(f"  cli: files present; val_img_4.gif {version} {w}x{h}, {n} frames; the exported "
            f"UNet ({len(sd)} tensors, {dtypes}) loads into UNetSpatioTemporalConditionModel "
            f"with strict=True ({time.time() - t0:.1f} s)")
        if dtypes != {"torch.float32"}:
            raise RuntimeError(f"cli: exported UNet dtypes {dtypes}")
        del sd, unet
        shutil.rmtree(os.path.join(a, "unet"))

        os.makedirs(b)
        shutil.copytree(os.path.join(a, "checkpoint-2"), os.path.join(b, "checkpoint-2"))
        run("B (checkpoint-2 resumed, steps 2-4)", b, "--resume_from_checkpoint", "latest")
        shutil.rmtree(os.path.join(b, "unet"))
        load = lambda d: torch.load(os.path.join(d, "checkpoint-4", "state", STATE_FILE),
                                    map_location="cpu", weights_only=True)
        data = [json.load(open(os.path.join(d, "checkpoint-4", "data_state.json")))
                for d in (a, b)]
        state_a = load(a)
        diff = compare_states(state_a, load(b))
        log(f"  cli resume: run B's checkpoint-4 against run A's: {diff}; data states {data}")
        if (not diff["same_names"] or diff["count"] != (4, 4) or diff["step"] != (4, 4)
                or data[0] != data[1] or data[0]["step"] != 4):
            raise RuntimeError(f"cli resume: counts or data step differ: {diff}, {data}")
        parts = ("masters", "exp_avg", "exp_avg_sq", "adamw_step")
        if any(diff[k] for k in parts):
            a2 = str(root / "a2")
            run("A2 (straight again)", a2)
            twice = compare_states(state_a, load(a2))
            log(f"  cli resume: not bit-equal; two straight runs differ by {twice}")
            worse = [k for k in parts if diff[k] > twice[k]]
            if worse:
                raise RuntimeError(f"cli resume: the resumed run differs more than two straight "
                                   f"runs in {worse}: {diff} against {twice}")
        else:
            log("  cli resume: masters, both moments, counts, step and data step bit-equal")
    finally:
        cli.run_validation = original
        shutil.rmtree(root, ignore_errors=True)
    log(f"  [{smi}] cli phase wall time {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------- the Tracklet2Video paths --

TRACKLET_DIM, TRACKLET_HEADS, TRACKLET_BOXES = 1024, 8, 16
# the gate of the UNet, gradient, train-step and infer checks: at 0 the
# branch is a no-op and its tokenizer's and enhancer's gradients are exactly
# zero (docs/TRACKLET.md, "Gradient flow note")
TRACKLET_GATE = 0.5
TRACKLET_CLI_STEPS = 2


def parallel_phase(dev, smi):
    """Data parallelism over a world of one (NCCL through the env rendezvous
    on localhost, as torchrun starts a rank) with train/cli.py at full width
    over the committed frames: the full scope for 3 steps without offload,
    with --host_offload masters and masters+moments (s/step, peak memory, the
    bytes streamed a step, the masters' placement); the temporal scope for 2
    steps with --zero1 and without, whose checkpoints must hold the same
    state bit for bit."""
    import shutil
    import socket

    import torch.distributed as dist

    from svd_xtend_tpu_torch import native
    from svd_xtend_tpu_torch.data import make_fixtures as fx
    from svd_xtend_tpu_torch.train import cli
    from svd_xtend_tpu_torch.train.checkpoint import STATE_FILE

    root = native.BUILD_DIR.parent / "parallel_smoke"
    shutil.rmtree(root, ignore_errors=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    def run(name, *extra):
        out = str(root / name)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        stats = cli.main(["--base_folder", fx.FRAMES, "--mixed_precision", "bf16",
                          "--learning_rate", "1e-5", "--lr_scheduler", "constant",
                          "--checkpoints_total_limit", "1", "--validation_steps", "1000",
                          "--num_inference_steps", "2", "--seed", "123", "--output_dir", out,
                          *extra])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        steps = stats["step_seconds"]
        if stats["world_size"] != 1 or dist.is_initialized():
            raise RuntimeError(f"{name}: world {stats['world_size']}, the process group left up")
        streamed = stats["streamed_bytes"][-1]
        log(f"  [{smi}] {name}: s/step {', '.join(f'{t:.3f}' for t in steps)} (median "
            f"{statistics.median(steps):.3f}); peak allocated {peak / 2**30:.2f} GiB; streamed "
            f"{streamed / 1e9:.3f} GB a step ({streamed / 1e9 / statistics.median(steps):.1f} "
            f"GB/s of the step's time); wall {time.time() - t0:.1f} s")
        return out, stats, peak

    try:
        full = ("--train_mode", "full", "--max_train_steps", "3", "--checkpointing_steps",
                "1000")
        results = {}
        for mode in ("none", "masters", "masters+moments"):
            results[mode] = run(f"full_{mode}", *full, "--host_offload", mode)
            shutil.rmtree(results[mode][0], ignore_errors=True)
        base = results["none"][2]
        for mode in ("masters", "masters+moments"):
            cut = (base - results[mode][2]) / 2**30
            log(f"  [{smi}] full scope, --host_offload {mode}: peak {results[mode][2] / 2**30:.2f}"
                f" GiB, {cut:.2f} GiB under no offload's {base / 2**30:.2f}")
            if results[mode][1]["streamed_bytes"][-1] <= 0 or cut <= 0:
                raise RuntimeError(f"--host_offload {mode}: nothing streamed or no memory saved")
        temporal = ("--train_mode", "temporal", "--max_train_steps", "2",
                    "--checkpointing_steps", "2")
        plain = run("temporal", *temporal)[0]
        zero = run("temporal_zero1", *temporal, "--zero1")[0]
        load = lambda d: torch.load(os.path.join(d, "checkpoint-2", "state", STATE_FILE),
                                    map_location="cpu", weights_only=True)
        a, b = load(plain), load(zero)
        same = _same_leaves(a, b)
        log(f"  --zero1 at world 1 against without: checkpoint-2 states {compare_states(a, b)}; "
            f"bit for bit: {same}")
        if not same:
            raise RuntimeError("--zero1 at world 1 holds another state than the run without it")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)


FRAMES_RANKS = 2
FRAMES_STEPS = 2            # generate's Euler steps in the frames phase
# the UNet's CFG pass in bf16, two ranks against one: 1e-2 was the aim, but
# the same pass as two passes of batch 1 (no collective; the kernels take
# other launch plans for half the rows, as a frames shard's do) lies 1.246e-2
# from it with these random weights, so the gate is that control's distance
# times FRAMES_CONTROL_RATIO; 1e-2 is printed beside it. The sharded logic
# itself is held in f32 on the plain versions (FRAMES_F32_REL).
FRAMES_PASS_REL = 1e-2
FRAMES_CONTROL_RATIO = 1.25
FRAMES_F32_REL = 1e-4
FRAMES_VIDEO_REL = 5e-2     # the video
FRAMES_STEP_REL = 1e-2      # the train step's loss and grad_norm
# the uneven split (ROADMAP A19): 14 frames over a frames axis of 4 (4, 4,
# 3, 3), generate alone (a train batch takes an even split only)
UNEVEN_RANKS = 4
UNEVEN_STEPS = 2


def frames_work(dev, world):
    """The frames phase's runs on `world` (one rank, or a rank of the frames
    group), from the same seeded weights and inputs on every process: the
    UNet's CFG pass at 512x320x14f (this rank's frames of it), generate at
    PipelineConfig(num_inference_steps=FRAMES_STEPS) (a warm-up, then a timed
    run), and two default temporal-scope steps (the first from the shared
    initial state, the second timed). Returns what the parent compares and
    prints: CPU tensors and numbers."""
    from svd_xtend_tpu_torch import parallel
    from svd_xtend_tpu_torch.core.config import MeshConfig, PipelineConfig, TrainConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels
    from svd_xtend_tpu_torch.ops import quant
    from svd_xtend_tpu_torch.ops.kernels import int8_quant as iq
    from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
    from svd_xtend_tpu_torch.ops.kernels.dispatch import plain_versions
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr
    from svd_xtend_tpu_torch.parallel.frames import STAGED
    from svd_xtend_tpu_torch.train.state import (cast_frozen_to_compute, create_train_state,
                                                 make_train_step)

    counters = kernel_counters()
    cfg = TrainConfig(mesh=MeshConfig(frames=world.frames))
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    models = SVDModels.create(device=dev, dtype=torch.float32, generator=gen)
    state = create_train_state(cfg, models, world=world)
    shard = world.frame_shard(cfg.num_frames)
    own = (lambda t: t) if shard is None else shard.own
    out = {}

    ucfg = models.unet.config
    sample = torch.randn(2, cfg.num_frames, cfg.height // 8, cfg.width // 8,
                         ucfg.in_channels, device=dev, generator=gen)
    ehs = torch.randn(2, 1, ucfg.cross_attention_dim, device=dev, generator=gen)
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device=dev)
    with torch.no_grad():
        # f32 with the plain versions (TF32 off): the sharded pass is the
        # one-rank pass to f32 rounding
        with plain_versions():
            out["pass_f32"] = models.unet(own(sample), 1.5, ehs, ids, shard=shard).cpu()
        cast_frozen_to_compute(models, torch.bfloat16)
        sample, ehs = sample.to(torch.bfloat16), ehs.to(torch.bfloat16)
        STAGED.reset()
        out["pass"] = models.unet(own(sample), 1.5, ehs, ids, shard=shard).float().cpu()
        out["pass_staged"] = STAGED.bytes
        if shard is None:
            # the control: the same pass as two of batch 1, whose kernels
            # take other launch plans (half the rows), as a frames shard's do
            out["pass_halves"] = torch.cat([
                models.unet(sample[i:i + 1], 1.5, ehs[i:i + 1], ids[i:i + 1]).float().cpu()
                for i in range(2)])

    # the int8 activation quantiser over the frames group: this rank's codes
    # are its frames of the one-rank codes, bit for bit
    x = torch.randn(2, cfg.num_frames, 40, 64, 320, device=dev,
                    generator=gen).to(torch.bfloat16)
    with quant.quantized("int8", None if shard is None else shard.group):
        q, stats = iq.quantize(own(x).reshape(-1, 40, 64, 320))
    rq, rstats = iq.quantize_reference(x.reshape(-1, 40, 64, 320))
    out["int8_same"] = bool(torch.equal(q, own(rq.reshape(x.shape)).reshape(q.shape))
                            and torch.equal(stats, rstats))

    pcfg = PipelineConfig(num_inference_steps=FRAMES_STEPS)
    image = torch.rand(1, pcfg.height, pcfg.width, 3, device=dev, generator=gen) * 2 - 1
    noise = (torch.randn(image.shape, device=dev, generator=gen),
             torch.randn(1, pcfg.num_frames, pcfg.height // 8, pcfg.width // 8, 4, device=dev,
                         generator=gen))

    def video():
        return parallel.generate_rows(models, image, pcfg, world, image_noise=noise[0],
                                      latent_noise=noise[1])

    video()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    STAGED.reset()
    with calls_by(ta, "frame_attention", SHAPE) as attention, \
            calls_by(tr, "conv_a", SHAPE) as conv_a:
        t0 = time.time()
        out["video"] = video().cpu()
        out["s_video"] = time.time() - t0
    out["video_launches"] = {n: f.launches for n, f in counters.items()}
    out["video_staged"] = STAGED.bytes
    out["video_peak"] = torch.cuda.max_memory_allocated()
    out["frame_attention_shapes"] = dict(attention)
    out["conv_a_shapes"] = dict(conv_a)

    batch = torch.rand(1, cfg.num_frames, cfg.height, cfg.width, 3, device=dev,
                       generator=gen) * 2 - 1
    step = make_train_step(models, cfg, world)
    state, first = step(state, batch, generator=torch.Generator(dev).manual_seed(SEED + 31))
    out["step"] = first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    STAGED.reset()
    t0 = time.time()
    state, _ = step(state, batch, generator=torch.Generator(dev).manual_seed(SEED + 32))
    torch.cuda.synchronize()
    out["s_step"] = time.time() - t0
    out["step_launches"] = {n: f.launches for n, f in counters.items()}
    out["step_staged"] = STAGED.bytes
    out["step_peak"] = torch.cuda.max_memory_allocated()
    return out


def work_rank(rank, port, results, size, mesh_kw, work):
    """A rank of a multi-rank phase: a gloo group of `size` ranks on
    localhost, every rank on cuda:0 (NCCL refuses two ranks on one card), the
    port's world laid out as ``MeshConfig(**mesh_kw)`` over it; runs the
    module function named `work` on (device, world)."""
    import traceback

    import torch.distributed as dist

    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK="0")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=size)
        from svd_xtend_tpu_torch import parallel
        from svd_xtend_tpu_torch.core.config import MeshConfig
        world = parallel.init_world("cuda", MeshConfig(**mesh_kw))
        try:
            # numpy, not tensors: torch would share a tensor's storage through
            # a descriptor that dies with this process
            out = {k: v.numpy() if torch.is_tensor(v) else v
                   for k, v in globals()[work](dev, world).items()}
            results.put((rank, True, out))
        finally:
            parallel.close_world(world)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(size, mesh_kw, work, what):
    """`size` processes of ``work_rank`` running `work`; their results by
    rank (numpy arrays back as tensors)."""
    import multiprocessing as mp
    import queue
    import socket

    import numpy as np

    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    results = ctx.Queue()
    procs = [ctx.Process(target=work_rank, args=(r, port, results, size, mesh_kw, work))
             for r in range(size)]
    t0 = time.time()
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            try:
                rank, ok, value = results.get(timeout=600)
            except queue.Empty:
                raise RuntimeError(f"{what}: a rank gave no answer within 600 s")
            if not ok:
                raise RuntimeError(f"{what}: rank {rank} failed:\n{value}")
            got[rank] = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                         for k, v in value.items()}
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    log(f"  {size} ranks: {time.time() - t0:.1f} s with their start and build")
    return got


def uneven_work(dev, world):
    """The uneven frames video on `world` (one rank, or a rank of a frames
    group of UNEVEN_RANKS): generate at PipelineConfig(num_inference_steps=
    UNEVEN_STEPS), 512x320x14f, from the frames phase's seeded weights;
    its seconds, launches and the frame attention and temporal resnet calls
    by shape."""
    from svd_xtend_tpu_torch import parallel
    from svd_xtend_tpu_torch.core.config import PipelineConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels
    from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr
    from svd_xtend_tpu_torch.parallel.frames import STAGED
    from svd_xtend_tpu_torch.train.state import cast_frozen_to_compute

    counters = kernel_counters()
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    models = cast_frozen_to_compute(SVDModels.create(device=dev, dtype=torch.float32,
                                                     generator=gen), torch.bfloat16)
    pcfg = PipelineConfig(num_inference_steps=UNEVEN_STEPS)
    image = torch.rand(1, pcfg.height, pcfg.width, 3, device=dev, generator=gen) * 2 - 1
    noise = (torch.randn(image.shape, device=dev, generator=gen),
             torch.randn(1, pcfg.num_frames, pcfg.height // 8, pcfg.width // 8, 4, device=dev,
                         generator=gen))
    shard = world.frame_shard(pcfg.num_frames)
    reset(counters)
    STAGED.reset()
    with calls_by(ta, "frame_attention", SHAPE) as attention, \
            calls_by(tr, "conv_a", SHAPE) as conv_a:
        torch.cuda.synchronize()
        t0 = time.time()
        video = parallel.generate_rows(models, image, pcfg, world, image_noise=noise[0],
                                       latent_noise=noise[1])
        torch.cuda.synchronize()
        seconds = time.time() - t0
    return {"video": video.cpu(), "s_video": seconds,
            "launches": {n: f.launches for n, f in counters.items()},
            "staged": STAGED.bytes, "frames": None if shard is None else shard.count,
            "frame_attention_shapes": dict(attention), "conv_a_shapes": dict(conv_a)}


def uneven_frames(smi, dev):
    """14 frames over a frames axis of UNEVEN_RANKS (four gloo ranks on the
    one card) against the one-rank video of the same UNEVEN_STEPS steps,
    at the frames phase's video bound; every rank returns the same video,
    holds its 4 or 3 frames, and its frame attention and temporal resnets
    see all 14. Returns rank 0's launches."""
    from svd_xtend_tpu_torch import parallel

    one = uneven_work(dev, parallel.SINGLE)
    torch.cuda.empty_cache()
    got = run_ranks(UNEVEN_RANKS, dict(frames=UNEVEN_RANKS), "uneven_work", "frames uneven")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    counts = [got[r]["frames"] for r in range(UNEVEN_RANKS)]
    log(f"  [{smi}] uneven split, 14 frames over {UNEVEN_RANKS} ranks as {counts}: one rank "
        f"s/video {one['s_video']:.3f} ({UNEVEN_STEPS} steps); ranks "
        f"{[round(got[r]['s_video'], 3) for r in range(UNEVEN_RANKS)]}, staged "
        f"{got[0]['staged'] / 1e6:.1f} MB a video a rank")
    for r in range(UNEVEN_RANKS):
        g = got[r]
        d = rel(g["video"], one["video"])
        log(f"  rank {r} ({counts[r]} frames): the video {d:.4g} against one rank (bound "
            f"{FRAMES_VIDEO_REL}); frame attention by (B, F, S_r, C) "
            f"{g['frame_attention_shapes']}; kernel A by shape {g['conv_a_shapes']}")
        if not d <= FRAMES_VIDEO_REL:
            raise RuntimeError(f"frames uneven: rank {r}'s video {d} from one rank")
        if not torch.equal(g["video"], got[0]["video"]):
            raise RuntimeError("frames uneven: the ranks returned different videos")
        shapes = list(g["frame_attention_shapes"]) + [k for k in g["conv_a_shapes"]
                                                      if k[0] == 2]
        if not shapes or any(k[1] != 14 for k in shapes):
            raise RuntimeError("frames uneven: the frame attention and the UNet's temporal "
                               "resnets must see all 14 frames")
        missing = [n for n in kernel_counters() if n not in BACKWARD_ONLY | OTHER_PATHS
                   and g["launches"][n] == 0]
        if missing:
            raise RuntimeError(f"frames uneven: rank {r} never launched {missing}")
    if counts != [4, 4, 3, 3] or not torch.isfinite(got[0]["video"]).all():
        raise RuntimeError(f"frames uneven: frames {counts}, or a video that is not finite")
    return got[0]["launches"]


def frames_phase(dev, smi):
    """Sequence parallelism over the 'frames' axis (parallel/frames.py): the
    one-rank runs of frames_work here, then FRAMES_RANKS ranks, each its own
    process on the one card over gloo with the collectives staged through
    host memory, held to them; then the uneven video (``uneven_frames``).
    Returns rank 0's launches by path."""
    from svd_xtend_tpu_torch import parallel

    t0 = time.time()
    one = frames_work(dev, parallel.SINGLE)
    log(f"  [{smi}] one rank: s/video {one['s_video']:.3f} ({FRAMES_STEPS} steps), s/step "
        f"{one['s_step']:.3f}, peak {one['video_peak'] / 2**30:.2f} / "
        f"{one['step_peak'] / 2**30:.2f} GiB (video / step); {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    got = run_ranks(FRAMES_RANKS, dict(frames=FRAMES_RANKS), "frames_work", "frames")

    whole = torch.cat([got[r]["pass"] for r in range(FRAMES_RANKS)], dim=1)
    whole32 = torch.cat([got[r]["pass_f32"] for r in range(FRAMES_RANKS)], dim=1)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    control = rel(one["pass_halves"], one["pass"])
    bf16 = rel(whole, one["pass"])
    log(f"  UNet CFG pass in bf16: {bf16:.4g} against one rank; the control (the one-rank "
        f"pass as two of batch 1) {control:.4g} from it; {FRAMES_PASS_REL} "
        f"{'met' if bf16 <= FRAMES_PASS_REL else 'not met'} (printed, not a gate)")
    checks = {"UNet CFG pass": (bf16, FRAMES_CONTROL_RATIO * control),
              "UNet CFG pass, f32 plain versions": (rel(whole32, one["pass_f32"]),
                                                    FRAMES_F32_REL)}
    for r in range(FRAMES_RANKS):
        checks[f"rank {r} video"] = (rel(got[r]["video"], one["video"]), FRAMES_VIDEO_REL)
        for key in ("loss", "grad_norm"):
            a, b = got[r]["step"][key], one["step"][key]
            checks[f"rank {r} step {key}"] = (abs(a - b) / abs(b), FRAMES_STEP_REL)
    for what, (value, bound) in checks.items():
        log(f"  {what}: {value:.4g} against one rank (bound {bound})")
    bad = [w for w, (v, b) in checks.items() if not v <= b]
    if bad:
        raise RuntimeError(f"frames: {bad} beyond their bounds")
    if not all(torch.equal(got[r]["video"], got[0]["video"]) for r in range(FRAMES_RANKS)):
        raise RuntimeError("frames: the ranks returned different videos")
    if not torch.isfinite(got[0]["video"]).all():
        raise RuntimeError("frames: the video is not finite")
    if not all(got[r]["int8_same"] for r in range(FRAMES_RANKS)):
        raise RuntimeError("frames: the int8 quantiser's codes over the frames group differ "
                           "from the one-rank codes")
    log("  int8 quantise over the frames group: each rank's codes its frames of the one-rank "
        "codes, bit for bit")

    count = 14 // FRAMES_RANKS
    for r in range(FRAMES_RANKS):
        g = got[r]
        log(f"  [{smi}] rank {r}: s/video {g['s_video']:.3f} ({FRAMES_STEPS} steps), s/step "
            f"{g['s_step']:.3f}, peak {g['video_peak'] / 2**30:.2f} / "
            f"{g['step_peak'] / 2**30:.2f} GiB (video / step); staged through the host: "
            f"{g['pass_staged'] / 1e6:.1f} MB a CFG UNet pass, {g['video_staged'] / 1e6:.1f} MB "
            f"a video, {g['step_staged'] / 1e6:.1f} MB a step (two ranks share the card and "
            "gloo stages every collective through host memory: not a multi-card rate)")
        shapes, conv_a = g["frame_attention_shapes"], g["conv_a_shapes"]
        log(f"  rank {r}: frame attention calls by (B, F, S_r, C): {shapes}; temporal resnet "
            f"kernel A by (B, F, S, C): {conv_a} (batch 2: the UNet's CFG pair; batch 1: the "
            "VAE decoder's chunks, whole on the rank that decodes them)")
        unet = [k for k in conv_a if k[0] == 2]
        if (not shapes or not unet or any(k[1] != 14 for k in list(shapes) + unet)
                or any(k[2] * FRAMES_RANKS > 2560 + FRAMES_RANKS for k in shapes)):
            raise RuntimeError("frames: the frame attention (a token shard) and the UNet's "
                               "temporal resnets must see all 14 frames")
        if g["pass"].shape[1] != count:
            raise RuntimeError(f"frames: rank {r}'s pass holds {g['pass'].shape[1]} frames")
    forward = [n for n in kernel_counters() if n not in BACKWARD_ONLY | OTHER_PATHS]
    step_names = [n for n in kernel_counters() if n not in OTHER_PATHS]
    for r in range(FRAMES_RANKS):
        for path, names in (("video_launches", forward), ("step_launches", step_names)):
            missing = [n for n in names if got[r][path][n] == 0]
            log(f"  rank {r} {path}: {dict((n, got[r][path][n]) for n in names)}")
            if missing:
                raise RuntimeError(f"frames: rank {r} never launched {missing} ({path})")
    return {"frames": got[0]["video_launches"], "frames_step": got[0]["step_launches"],
            "frames_uneven": uneven_frames(smi, dev)}


MODEL_RANKS = 2
MODEL_STEPS = 2             # generate's Euler steps in the model phase
# the UNet's CFG pass in bf16, two model ranks against one: 1e-2, or where
# the one-rank launch-plan control (split_row_products: each row-parallel
# product as MODEL_RANKS K-slices whose bf16 partials are summed in rank
# order, no collective) lies farther than 1e-2 from the one-rank pass,
# MODEL_CONTROL_RATIO times the control's distance; the sharded logic itself
# is held in f32 on the plain versions (MODEL_F32_REL)
MODEL_PASS_REL = 1e-2
MODEL_CONTROL_RATIO = 1.25
MODEL_F32_REL = 1e-4
MODEL_VIDEO_REL = 5e-2
# the train step's loss and grad_norm: the JAX package's bounds for a
# sharded step against one device (tests/test_sharding.py:89-92), or where
# the one-rank launch-plan control's steps lie farther, MODEL_CONTROL_RATIO
# times the control's distance (bf16 partials move a second step's loss by
# more than 2e-4)
MODEL_LOSS_RTOL = 2e-4
MODEL_GRAD_NORM_RTOL = 2e-3
# a flash / frame attention call's (q's shape, heads)
HEADS_KEY = lambda q, k, v, *_, num_heads, **__: (tuple(q.shape), num_heads)


@contextlib.contextmanager
def split_row_products(unet, n):
    """The model phase's one-rank launch-plan control: inside the block
    every row-parallel product of `unet`'s transformers (the attentions'
    to_out, proj_out and the GEGLU feed-forward's second product) runs as
    the n K-slices of a model axis of n, each partial rounded to bf16 and
    summed in rank order, then the bias (and the GEGLU's residual): a model
    axis's arithmetic in one process, without a collective."""
    from svd_xtend_tpu_torch.models import transformer as tf
    from svd_xtend_tpu_torch.ops.kernels import geglu as gg
    from svd_xtend_tpu_torch.parallel import tensor as tpl

    sizes = {m: tpl.layout(f"{name}.weight", unet.config, n).sizes
             for name, m in unet.named_modules()
             if isinstance(m, tf.QLinear) and name.endswith(("to_out.0", "proj_out"))}
    forward, residual = tf.QLinear.forward, tf.residual_geglu

    def split_forward(self, x):
        if self not in sizes:
            return forward(self, x)
        y, start = None, 0
        for k in sizes[self]:
            part = F.linear(x[..., start:start + k], self.weight[:, start:start + k])
            y, start = part if y is None else y + part, start + k
        return y + self.bias

    def split_geglu(x, ln, ff):
        proj, out = ff.net[0].proj, ff.net[2]
        inner = out.in_features
        y, start = None, 0
        for k in tpl.ff_split(inner, n):
            rows = lambda t: torch.cat([t[start:start + k], t[inner + start:inner + start + k]])
            part = gg.ln_geglu_partial(x, ln.weight, ln.bias, rows(proj.weight),
                                       rows(proj.bias),
                                       out.weight[:, start:start + k].contiguous())
            y, start = part if y is None else y + part, start + k
        return x + (y + out.bias)

    tf.QLinear.forward, tf.residual_geglu = split_forward, split_geglu
    try:
        yield
    finally:
        tf.QLinear.forward, tf.residual_geglu = forward, residual


# the combinations a 'model' axis took last (ROADMAP A20), one default
# temporal-scope-sized step each at model MODEL_RANKS against one rank
A20_SCOPES = {"lora": dict(train_mode="lora"), "8-bit AdamW": dict(use_8bit_adam=True),
              "host offload": dict(host_offload="masters+moments"),
              "head-mixing processor": dict()}


def mix_heads(q, k, v, *, num_heads, scale, site):
    """An attention processor that mixes heads (each head's queries plus the
    previous head's, then SDPA per head): under a model axis it needs every
    head, which the port gathers for it."""
    heads = lambda x: x.unflatten(-1, (num_heads, -1)).transpose(1, 2)
    qh = heads(q)
    o = F.scaled_dot_product_attention(qh + qh.roll(1, dims=1), heads(k), heads(v), scale=scale)
    return o.transpose(1, 2).flatten(2)


def a20_steps(dev, world, models, cfg, state, start, batch, seeded):
    """One step of each A20_SCOPES combination from the weights `start`
    (the temporal masters the phase began with, host copies written back
    before each);
    on one rank each also under the launch-plan control. Returns
    {name: metrics with the step's seconds and its masters' change}."""
    import dataclasses

    from svd_xtend_tpu_torch.models import attn_processor
    from svd_xtend_tpu_torch.train.state import (create_train_state, make_train_step,
                                                 write_back)

    def one_step(scope_kw, proc, control):
        write_back(models, cfg, state, start)
        acfg = dataclasses.replace(cfg, **scope_kw)
        st = create_train_state(acfg, models, world=world)
        before = [p.detach().to(dev, copy=True) for p in st.params]
        fn = make_train_step(models, acfg, world)
        with (split_row_products(models.unet, MODEL_RANKS) if control
              else contextlib.nullcontext()), \
                (attn_processor.processors(proc) if proc else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t0 = time.time()
            st, m = fn(st, batch, generator=seeded(0))
            torch.cuda.synchronize()
            m["s"] = time.time() - t0
        change = [p.detach().to(dev) - b for p, b in zip(st.params, before)]
        m["changed"] = sum(int((c != 0).sum()) for c in change)
        m["change_norm"] = math.sqrt(sum(float(c.double().square().sum()) for c in change))
        m["offloaded"] = all(not p.is_cuda for p in st.params)
        m["moment_bytes"] = st.optimizer.moment_bytes()
        del st, fn, before, change
        torch.cuda.empty_cache()
        return m

    out = {}
    for what, scope_kw in A20_SCOPES.items():
        proc = mix_heads if what == "head-mixing processor" else None
        out[what] = one_step(scope_kw, proc, False)
        if world.model == 1:
            out[what + " control"] = one_step(scope_kw, proc, True)
    write_back(models, cfg, state, start)
    return out


def direct_8bit(dev, world, state):
    """The model-axis 8-bit update against the one-rank one on the card: the
    same seeded whole gradients of every split tensor of the temporal scope
    (each rank generates them all), one AdamW8bit update over the whole
    tensors and one over this rank's parts (the block absmaxes joined over
    the model group); this rank's codes and scales must be the one-rank
    update's at its values, bit for bit. Returns (tensors, codes compared,
    int8 moments, whether all were equal)."""
    from svd_xtend_tpu_torch.train.quant import AdamW8bit, Quantized, part_of

    opt = state.optimizer
    idx = [i for i, part in enumerate(opt.parts) if part is not None]
    gen = torch.Generator(dev).manual_seed(SEED + 45)
    wholes = [torch.randn(opt.parts[i].shape, device=dev, generator=gen) * 10.0 ** -(1 + k % 4)
              for k, i in enumerate(idx)]
    parts, axes = [opt.parts[i] for i in idx], [opt.axes[i] for i in idx]
    local = [p.layout.shard(g, p.index) for p, g in zip(parts, wholes)]
    one = AdamW8bit([torch.zeros_like(g) for g in wholes], axes=axes)
    one.step(wholes, 1e-4)
    split = AdamW8bit([torch.zeros_like(g) for g in local], axes=axes, parts=parts,
                      group=world.model_group)
    split.step(local, 1e-4)
    equal, codes, int8 = True, 0, 0
    for k in range(len(idx)):
        for ref, mine in ((one.mu[k], split.mu[k]), (one.nu[k], split.nu[k])):
            if isinstance(ref, Quantized):
                want = part_of({"q": ref.q, "scale": ref.scale}, parts[k], axes[k])
                equal &= bool(torch.equal(mine.q, want["q"]) and torch.equal(mine.scale,
                                                                             want["scale"]))
                codes, int8 = codes + mine.q.numel(), int8 + 1
            else:
                equal &= bool(torch.equal(mine, parts[k].layout.shard(ref, parts[k].index)))
    return len(idx), codes, int8, equal


def model_work(dev, world):
    """The model phase's runs on `world` (one rank, or a rank of the model
    group), from the same seeded weights and inputs on every process (a
    model rank keeps its part of them): the UNet's CFG pass at 512x320x14f,
    generate at PipelineConfig(num_inference_steps=MODEL_STEPS) (a warm-up,
    then a timed run), and two default temporal-scope steps (the second
    timed). Returns what the parent compares and prints: CPU tensors and
    numbers."""
    from svd_xtend_tpu_torch import parallel
    from svd_xtend_tpu_torch.core.config import MeshConfig, PipelineConfig, TrainConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
    from svd_xtend_tpu_torch.ops.kernels import geglu as gg
    from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
    from svd_xtend_tpu_torch.ops.kernels.dispatch import plain_versions
    from svd_xtend_tpu_torch.parallel import tensor as tpl
    from svd_xtend_tpu_torch.parallel.frames import STAGED
    from svd_xtend_tpu_torch.train.state import (cast_frozen_to_compute, create_train_state,
                                                 make_train_step, write_back)

    counters = kernel_counters()
    cfg = TrainConfig(mesh=MeshConfig(model=world.model))
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    models = SVDModels.create(device=dev, dtype=torch.float32, generator=gen,
                              tp=world.tensor_shard())
    state = create_train_state(cfg, models, world=world)
    # the A20 steps' start, in host memory (out of the card's peaks)
    masters = [p.detach().cpu() for p in state.params]
    out = {}
    counts = lambda: {n: f.launches for n, f in counters.items()}

    ucfg = models.unet.config
    sample = torch.randn(2, cfg.num_frames, cfg.height // 8, cfg.width // 8,
                         ucfg.in_channels, device=dev, generator=gen)
    ehs = torch.randn(2, 1, ucfg.cross_attention_dim, device=dev, generator=gen)
    ids = torch.tensor([[6.0, 127.0, 0.02]] * 2, device=dev)
    with torch.no_grad():
        with plain_versions():
            out["pass_f32"] = models.unet(sample, 1.5, ehs, ids).cpu()
        cast_frozen_to_compute(models, torch.bfloat16)
        sample, ehs = sample.to(torch.bfloat16), ehs.to(torch.bfloat16)
        reset(counters)
        STAGED.reset()
        with calls_by(fa, "flash_attention_packed", HEADS_KEY) as flash, \
                calls_by(ta, "frame_attention", HEADS_KEY) as frame, \
                calls_by(tpl, "_all_reduce", SHAPE) as reduces, \
                calls_by(tpl, "_all_gather_last", SHAPE) as gathers, \
                calls_by(gg, "ln_geglu_partial" if world.model > 1 else "ln_geglu_residual",
                         GEGLU_KEY) as geglu:
            out["pass"] = models.unet(sample, 1.5, ehs, ids).float().cpu()
        out["pass_staged"] = STAGED.bytes
        out["pass_launches"] = counts()
        out["flash_heads"], out["frame_heads"] = dict(flash), dict(frame)
        out["reduces"], out["gathers"], out["geglu"] = dict(reduces), dict(gathers), dict(geglu)
        if world.model == 1:
            with split_row_products(models.unet, MODEL_RANKS):
                out["pass_control"] = models.unet(sample, 1.5, ehs, ids).float().cpu()

    pcfg = PipelineConfig(num_inference_steps=MODEL_STEPS)
    image = torch.rand(1, pcfg.height, pcfg.width, 3, device=dev, generator=gen) * 2 - 1
    noise = (torch.randn(image.shape, device=dev, generator=gen),
             torch.randn(1, pcfg.num_frames, pcfg.height // 8, pcfg.width // 8, 4, device=dev,
                         generator=gen))

    def video():
        return parallel.generate_rows(models, image, pcfg, world, image_noise=noise[0],
                                      latent_noise=noise[1])

    video()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    STAGED.reset()
    t0 = time.time()
    out["video"] = video().cpu()
    out["s_video"] = time.time() - t0
    out["video_launches"] = counts()
    out["video_staged"] = STAGED.bytes
    out["video_peak"] = torch.cuda.max_memory_allocated()

    batch = torch.rand(1, cfg.num_frames, cfg.height, cfg.width, 3, device=dev,
                       generator=gen) * 2 - 1
    step = make_train_step(models, cfg, world)
    seeded = lambda i: torch.Generator(dev).manual_seed(SEED + 41 + i)
    if world.model == 1:
        # the steps' launch-plan control, from the same state, which is then
        # restored (bit for bit, as a resume)
        start = state.state_dict()
        with split_row_products(models.unet, MODEL_RANKS):
            out["steps_control"] = [step(state, batch, generator=seeded(i))[1]
                                    for i in range(2)]
        state.load_state_dict(start)
        write_back(models, cfg, state)
        del start
    state, first = step(state, batch, generator=seeded(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    STAGED.reset()
    t0 = time.time()
    state, second = step(state, batch, generator=seeded(1))
    torch.cuda.synchronize()
    out["s_step"] = time.time() - t0
    out["steps"] = [first, second]
    out["step_launches"] = counts()
    out["step_staged"] = STAGED.bytes
    out["step_peak"] = torch.cuda.max_memory_allocated()
    out["a20"] = a20_steps(dev, world, models, cfg, state, masters, batch, seeded)
    if world.model > 1:
        out["direct_8bit"] = direct_8bit(dev, world, state)
    return out


def model_phase(dev, smi, ph: KernelPhase):
    """Tensor parallelism over the 'model' axis (parallel/tensor.py): the
    one-rank runs of model_work here, then MODEL_RANKS ranks, each its own
    process on the one card over gloo with the collectives staged through
    host memory, held to them. Returns rank 0's launches by path."""
    from svd_xtend_tpu_torch import parallel
    from svd_xtend_tpu_torch.parallel import tensor as tpl

    t0 = time.time()
    one = model_work(dev, parallel.SINGLE)
    log(f"  [{smi}] one rank: s/video {one['s_video']:.3f} ({MODEL_STEPS} steps), s/step "
        f"{one['s_step']:.3f}, peak {one['video_peak'] / 2**30:.2f} / "
        f"{one['step_peak'] / 2**30:.2f} GiB (video / step); {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()
    got = run_ranks(MODEL_RANKS, dict(model=MODEL_RANKS), "model_work", "model")

    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    bf16, control = rel(got[0]["pass"], one["pass"]), rel(one["pass_control"], one["pass"])
    bound = MODEL_PASS_REL if control <= MODEL_PASS_REL else MODEL_CONTROL_RATIO * control
    log(f"  UNet CFG pass in bf16: {bf16:.4g} against one rank; the control (each row-parallel "
        f"product as {MODEL_RANKS} K-slices, bf16 partials summed in rank order) {control:.4g} "
        f"from it, the ranks {rel(got[0]['pass'], one['pass_control']):.4g} from the control; "
        f"gate {bound:.4g} ({MODEL_PASS_REL}, or {MODEL_CONTROL_RATIO} x the control above it)")
    checks = {"UNet CFG pass": (bf16, bound),
              "UNet CFG pass, f32 plain versions": (rel(got[0]["pass_f32"], one["pass_f32"]),
                                                    MODEL_F32_REL)}
    off = lambda a, b, key: abs(a[key] - b[key]) / abs(b[key])
    for i, (c, b) in enumerate(zip(one["steps_control"], one["steps"])):
        for key, jax_bound in (("loss", MODEL_LOSS_RTOL), ("grad_norm", MODEL_GRAD_NORM_RTOL)):
            log(f"  step {i + 1} {key}: the control {off(c, b, key):.4g} from one rank, the "
                f"ranks {off(got[0]['steps'][i], c, key):.4g} from the control; JAX's bound "
                f"{jax_bound}")
    for r in range(MODEL_RANKS):
        checks[f"rank {r} video"] = (rel(got[r]["video"], one["video"]), MODEL_VIDEO_REL)
        for i, (a, b) in enumerate(zip(got[r]["steps"], one["steps"])):
            for key, jax_bound in (("loss", MODEL_LOSS_RTOL),
                                   ("grad_norm", MODEL_GRAD_NORM_RTOL)):
                control = MODEL_CONTROL_RATIO * off(one["steps_control"][i], b, key)
                checks[f"rank {r} step {i + 1} {key}"] = (off(a, b, key),
                                                          max(jax_bound, control))
    for what in A20_SCOPES:
        b, c = one["a20"][what], one["a20"][what + " control"]
        for key, jax_bound in (("loss", MODEL_LOSS_RTOL), ("grad_norm", MODEL_GRAD_NORM_RTOL)):
            log(f"  {what} step {key}: the control {off(c, b, key):.4g} from one rank, the ranks "
                f"{off(got[0]['a20'][what], c, key):.4g} from the control")
            for r in range(MODEL_RANKS):
                checks[f"rank {r} {what} step {key}"] = (
                    off(got[r]["a20"][what], b, key),
                    max(jax_bound, MODEL_CONTROL_RATIO * off(c, b, key)))
    for what, (value, b) in checks.items():
        log(f"  {what}: {value:.4g} against one rank (bound {b})")
    bad = [w for w, (v, b) in checks.items() if not v <= b]
    if bad:
        raise RuntimeError(f"model: {bad} beyond their bounds")
    for what in A20_SCOPES:
        for r, g in [(None, one)] + [(r, got[r]) for r in range(MODEL_RANKS)]:
            m = g["a20"][what]
            log(f"  [{smi}] {'one rank' if r is None else f'rank {r}'} {what}: loss "
                f"{m['loss']:.6g}, grad_norm {m['grad_norm']:.6g}, {m['s']:.3f} s the step, "
                f"{m['changed']} master values changed (norm of the change "
                f"{m['change_norm']:.4g}), moments {m['moment_bytes']} bytes"
                + (", masters in host memory" if m["offloaded"] else ""))
            if not (m["changed"] and math.isfinite(m["change_norm"])):
                raise RuntimeError(f"model: {what} left the masters unchanged or not finite")
            if (what == "host offload") != m["offloaded"]:
                raise RuntimeError(f"model: {what}: masters in host memory {m['offloaded']}")
    for r in range(MODEL_RANKS):
        tensors, codes, int8, equal = got[r]["direct_8bit"]
        log(f"  rank {r}: one model-axis 8-bit update on the one-rank update's gradients (every "
            f"split tensor of the temporal scope, {tensors}): {codes} int8 codes of {int8} "
            f"moments and their whole blocks' scales {'equal' if equal else 'NOT equal'} to the "
            "one-rank update's, bit for bit")
        if not equal or not int8:
            raise RuntimeError(f"model: rank {r}'s 8-bit codes differ from one rank's")
    for key in ("pass", "video"):
        if not all(torch.equal(got[r][key], got[0][key]) for r in range(MODEL_RANKS)):
            raise RuntimeError(f"model: the ranks returned different {key} outputs")
    if not torch.isfinite(got[0]["video"]).all():
        raise RuntimeError("model: the video is not finite")

    # every GEGLU site on the partial form's kernel, none on the module path
    # or the whole form; every attention site on its kernel at the local heads
    for r in range(MODEL_RANKS):
        g = got[r]
        for path in ("pass_launches", "video_launches", "step_launches"):
            whole, part = one[path]["geglu_fwd"], g[path]["geglu_partial"]
            log(f"  rank {r} {path}: geglu_partial {part} (one rank's geglu_fwd {whole}), "
                f"flash forward {g[path]['flash_attention_fwd']}, backward dQ "
                f"{g[path]['flash_attention_bwd_dq']} dK/dV {g[path]['flash_attention_bwd_dkv']}, "
                f"frame attention {g[path]['frame_attention_fwd']}")
            if part != whole or g[path]["geglu_fwd"] or not whole:
                raise RuntimeError(f"model: rank {r} {path}: {part} partial-form GEGLU launches "
                                   f"and {g[path]['geglu_fwd']} whole-form ones, one rank "
                                   f"{whole}")
            for name in ("flash_attention_fwd", "frame_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"):
                if g[path][name] != one[path][name]:
                    raise RuntimeError(f"model: rank {r} {path}: {g[path][name]} {name} "
                                       f"launches, one rank {one[path][name]}")
        for key in ("flash_heads", "frame_heads"):
            want = collections.Counter()
            for (shape, heads), n in one[key].items():
                local = tpl.split(heads, MODEL_RANKS)[r]
                want[(shape[:-1] + (local * shape[-1] // heads,), local)] += n
            log(f"  rank {r} {key} by (q's shape, heads): {g[key]}")
            if g[key] != dict(want):
                raise RuntimeError(f"model: rank {r} {key} {g[key]}, not the local heads {want}")

    # what the name rules cover: the UNet's sharded values, and the frozen
    # towers' values JAX's layout would shard where the port replicates
    from svd_xtend_tpu_torch.core.config import CLIPVisionConfig, UNetConfig, VAEConfig
    from svd_xtend_tpu_torch.models.clip import CLIPVisionModelWithProjection
    from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel
    from svd_xtend_tpu_torch.models.vae import AutoencoderKLTemporalDecoder
    for build, cfg in ((UNetSpatioTemporalConditionModel, UNetConfig()),
                       (CLIPVisionModelWithProjection, CLIPVisionConfig()),
                       (AutoencoderKLTemporalDecoder, VAEConfig())):
        with torch.device("meta"):
            net = build(cfg)
        ruled = sum(p.numel() for name, p in net.named_parameters() if p.dim() >= 2 and (
            tpl.COLUMN_PARALLEL.search(name.rsplit(".", 1)[0])
            or tpl.ROW_PARALLEL.search(name.rsplit(".", 1)[0])))
        total = sum(p.numel() for p in net.parameters())
        log(f"  {build.__name__}: {total / 1e6:.1f}M values, {ruled / 1e6:.1f}M under the "
            f"tensor-parallel name rules ({ruled * (MODEL_RANKS - 1) / MODEL_RANKS * 2 / 1e9:.3f} "
            f"GB of bf16 a rank saves at model {MODEL_RANKS} where they are sharded)")
    g = got[0]
    reduce_bytes = sum(math.prod(shape) * n * 2 for shape, n in g["reduces"].items())
    gather_bytes = sum(math.prod(shape) * n * 2 for shape, n in g["gathers"].items())
    n_models = 16
    log(f"  collectives a CFG UNet pass per rank: {sum(g['reduces'].values())} all-reduces "
        f"({reduce_bytes / 1e9:.3f} GB of bf16), {sum(g['gathers'].values())} all-gathers "
        f"({gather_bytes / 1e9:.3f} GB of a rank's parts); per transformer model (of "
        f"{n_models}) {sum(g['reduces'].values()) / n_models:.2f} all-reduces; by shape "
        f"{g['reduces']}")
    whole_ms = sum(ph.geglu_ms[tc] * n for tc, n in one["geglu"].items())
    part_ms = sum(ph.geglu_partial_ms[(t, c, 4 * c // MODEL_RANKS)] * n
                  for (t, c), n in g["geglu"].items())
    log(f"  [{smi}] GEGLU a CFG UNet pass, launches x the kernel phase's device ms: partial form "
        f"{part_ms:.3f} ms a rank ({g['geglu']}), whole form {whole_ms:.3f} ms on one rank")
    for r in range(MODEL_RANKS):
        g = got[r]
        log(f"  [{smi}] rank {r}: s/video {g['s_video']:.3f} ({MODEL_STEPS} steps), s/step "
            f"{g['s_step']:.3f}, peak {g['video_peak'] / 2**30:.2f} / "
            f"{g['step_peak'] / 2**30:.2f} GiB (video / step; one rank "
            f"{one['video_peak'] / 2**30:.2f} / {one['step_peak'] / 2**30:.2f}); staged through "
            f"the host: {g['pass_staged'] / 1e6:.1f} MB a CFG UNet pass, "
            f"{g['video_staged'] / 1e6:.1f} MB a video, {g['step_staged'] / 1e6:.1f} MB a step "
            "(two ranks share the card and gloo stages every collective through host memory: "
            "not a multi-card rate)")
        for i, (a, b) in enumerate(zip(g["steps"], one["steps"])):
            log(f"  rank {r} step {i + 1}: loss {a['loss']:.6g} (one rank {b['loss']:.6g}), "
                f"grad_norm {a['grad_norm']:.6g} ({b['grad_norm']:.6g})")
    forward = [n for n in kernel_counters() if n not in BACKWARD_ONLY | OTHER_PATHS
               | {"geglu_fwd"}] + ["geglu_partial"]
    step_names = [n for n in kernel_counters() if n not in OTHER_PATHS | {"geglu_fwd"}]
    step_names.append("geglu_partial")
    for r in range(MODEL_RANKS):
        for path, names in (("video_launches", forward), ("step_launches", step_names)):
            missing = [n for n in names if got[r][path][n] == 0]
            if missing:
                raise RuntimeError(f"model: rank {r} never launched {missing} ({path})")
    return {"model": got[0]["video_launches"], "model_step": got[0]["step_launches"]}


def _same_leaves(a, b) -> bool:
    """Equal nested dicts / lists of tensors and numbers, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_leaves(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_leaves(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def seeded_boxes(gen, b, f, n, device):
    """(b, f, n, 4) boxes in [0, 1] with x1 < x2 and y1 < y2, and a mask with
    about a quarter of the slots empty; f32."""
    a = torch.rand(b, f, n, 4, generator=gen, device=gen.device).to(device)
    boxes = torch.cat([torch.minimum(a[..., :2], a[..., 2:]),
                       torch.maximum(a[..., :2], a[..., 2:])], dim=-1)
    mask = (torch.rand(b, f, n, generator=gen, device=gen.device) > 0.25).float().to(device)
    return boxes, mask


def gated_levels(height, width):
    """[((S_q, S_kv), heads)] of the gated attention at the UNet's four
    levels of a (height, width) video with TRACKLET_BOXES box tokens."""
    from svd_xtend_tpu_torch.core.config import UNetConfig
    keys = [k for k in flash_calls_per_pass(height, width, TRACKLET_BOXES) if k[0] != k[1]]
    return list(zip(keys, UNetConfig().num_attention_heads))


def tracklet_kernel_phase(dev, ph: KernelPhase):
    """The flash forward at the gated attention's (S, S + 16) at generate's
    batches 28 and 14, then with its LSE and the backward pair at the
    'tracklet' step's batch 14: each against its plain version, device ms
    beside SDPA's and the bound."""
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    rn = lambda *s, sc=1.0: (torch.randn(*s, device=dev, generator=g) * sc).to(torch.bfloat16)
    log("  gated attention forward: queries S against S + 16 box tokens, batch 28 and 14")
    for (s, t), h in gated_levels(320, 512):
        for b in (28, 14):
            q, k, v = rn(b, s, h * 64), rn(b, t, h * 64), rn(b, t, h * 64)
            run = lambda: fa.flash_attention_packed(q, k, v, num_heads=h, scale=0.125)
            ph.check("flash_attention_fwd", run(),
                     fa.flash_attention_packed_reference(q, k, v, num_heads=h, scale=0.125),
                     f"{(b, s, h * 64)} keys {t} heads {h}")
            heads = lambda a: a.view(b, a.shape[1], h, 64).transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                          scale=0.125)
            ph.forward_level("generate", b, s, h, run, sdpa, nbytes(q, k, v, q), t)
            del q, k, v
    log("  gated attention forward with LSE and the backward pair, the 'tracklet' step's "
        "batch 14")
    for (s, t), h in gated_levels(320, 512):
        flash_train_level(ph, rn, 14, s, h, t)


def tracklet_unet_phase(dev):
    """The full-width UNet with the branch at gate TRACKLET_GATE and 16
    boxes, on a 2-frame 16x16 latent: the card's bf16 output against the
    host f32 UNet's from the same weights, then the gradient of
    edm_denoising_loss with respect to the branch (remat "block") against
    the host f32 one and the card's bf16 plain path's."""
    import dataclasses

    from svd_xtend_tpu_torch.core.config import TrainConfig, UNetConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels, init_random_
    from svd_xtend_tpu_torch.diffusion.training import TrainBatchEncodings, edm_denoising_loss
    from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel
    from svd_xtend_tpu_torch.ops.kernels.dispatch import plain_versions
    from svd_xtend_tpu_torch.train.state import trainable_mask

    cfg = dataclasses.replace(UNetConfig(), tracklet_dim=TRACKLET_DIM,
                              tracklet_heads=TRACKLET_HEADS, tracklet_gate_init=TRACKLET_GATE)
    with torch.device(dev):
        gpu = UNetSpatioTemporalConditionModel(cfg)
    init_random_(gpu, torch.Generator(device=dev).manual_seed(SEED + 21))
    with torch.device("meta"):
        cpu = UNetSpatioTemporalConditionModel(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, strict=True,
                        assign=True)
    gpu, cpu = gpu.to(torch.bfloat16).eval(), cpu.eval()
    in_branch = trainable_mask(cpu, "tracklet")
    n_branch = sum(p.numel() for n, p in cpu.named_parameters() if in_branch[n])
    gen = torch.Generator().manual_seed(SEED + 22)
    sample = torch.randn(1, 2, 16, 16, cfg.in_channels, generator=gen)
    ehs = torch.randn(1, 1, cfg.cross_attention_dim, generator=gen)
    ids = torch.tensor([[6.0, 127.0, 0.02]])
    t = torch.tensor(0.25 * math.log(10.0))
    boxes, mask = seeded_boxes(gen, 1, 2, TRACKLET_BOXES, "cpu")
    on = lambda *xs: [x.to(dev) for x in xs]
    with torch.no_grad():
        got = gpu(*on(sample), t, *on(ehs, ids), boxes=boxes.to(dev),
                  box_mask=mask.to(dev)).float().cpu()
        t0 = time.time()
        ref = cpu(sample, t, ehs, ids, boxes=boxes, box_mask=mask)
        log(f"  host f32 tracklet UNet forward {time.time() - t0:.1f} s")
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"  full-width tracklet UNet ({n_branch} branch values, gate {TRACKLET_GATE}, "
        f"{TRACKLET_BOXES} boxes) on (1, 2, 16, 16, 8): rel_l2 {rel:.4g} (bound "
        f"{UNET_REL_L2_BOUND}) max_abs {(got - ref).abs().max().item():.4g}")
    if not bool(torch.isfinite(got).all()) or rel > UNET_REL_L2_BOUND:
        raise RuntimeError(f"tracklet UNet: rel_l2 {rel} above {UNET_REL_L2_BOUND}")

    enc = TrainBatchEncodings(latents=torch.randn(1, 2, 16, 16, 4, generator=gen),
                              cond_latents=torch.randn(1, 16, 16, 4, generator=gen),
                              image_embeds=ehs, noise_aug=torch.tensor([0.02]))
    sigma, noise = torch.tensor([1.7]), torch.randn(1, 2, 16, 16, 4, generator=gen)
    tcfg = TrainConfig(train_mode="tracklet", remat_policy="block")

    def branch_grad(unet, device):
        names = [n for n, m in trainable_mask(unet, "tracklet").items() if m]
        named = dict(unet.named_parameters())
        params = [named[n] for n in names]
        unet.requires_grad_(False)
        for p in params:
            p.requires_grad_(True)
        e = TrainBatchEncodings(*(x.to(device) for x in enc))
        loss = edm_denoising_loss(SVDModels(unet, None, None), e, tcfg, sigma.to(device),
                                  noise.to(device), boxes.to(device), mask.to(device))
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        unet.requires_grad_(False)
        return loss.item(), torch.cat([g.float().flatten().cpu() for g in grads])

    t0 = time.time()
    loss_ref, g_ref = branch_grad(cpu, "cpu")
    log(f"  host f32 loss + branch gradient {time.time() - t0:.1f} s")
    loss_k, g_k = branch_grad(gpu, dev)
    with plain_versions():
        loss_p, g_p = branch_grad(gpu, dev)
    rel_k = ((g_k - g_ref).norm() / g_ref.norm()).item()
    rel_p = ((g_p - g_ref).norm() / g_ref.norm()).item()
    log(f"  branch gradient ({g_ref.numel()} values, remat block), loss {loss_ref:.5g} host, "
        f"{loss_k:.5g} kernels, {loss_p:.5g} plain: rel_l2 kernels {rel_k:.4g}, bf16 plain "
        f"{rel_p:.4g} (bounds {GRAD_REL_L2_BOUND}, {GRAD_PLAIN_RATIO}x plain)")
    if (not bool(torch.isfinite(g_k).all()) or rel_k >= GRAD_REL_L2_BOUND
            or rel_k > GRAD_PLAIN_RATIO * rel_p):
        raise RuntimeError(f"tracklet branch gradient: rel_l2 {rel_k} (plain {rel_p})")


def tracklet_video_phase(dev, smi, counters, ph: KernelPhase, gen_launches):
    """generate with 16 boxes at PipelineConfig(): at gate 0 the exact video
    equals the no-branch video bit for bit (same image and noise); at gate
    TRACKLET_GATE the exact, k3 and n3+k3 modes, a warm-up and
    GENERATE_TIMED timed videos each: the flash forward's launches per video
    by (batch, S_q, S_kv) held to the schedule's passes x
    flash_calls_per_pass, every other kernel's to the same mode's launches
    without boxes; s/video (median), peak memory. Returns {path: launches}
    of each mode's last timed video."""
    import dataclasses

    from svd_xtend_tpu_torch.core.config import PipelineConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels, generate
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    models = SVDModels.create(device=dev, dtype=torch.bfloat16, generator=gen)
    exact = PipelineConfig()
    f = exact.num_frames
    image = torch.rand(1, exact.height, exact.width, 3, device=dev, generator=gen) * 2 - 1
    boxes, mask = seeded_boxes(gen, 1, f, TRACKLET_BOXES, dev)
    noise = lambda: torch.Generator(device=dev).manual_seed(SEED)
    plain = generate(models, image, exact, generator=noise())
    branch = lambda gate: models.with_tracklet(TRACKLET_DIM, TRACKLET_HEADS, gate_init=gate,
                                               generator=torch.Generator(dev).manual_seed(
                                                   SEED + 25))
    zero = branch(0.0)
    boxed = generate(zero, image, exact, generator=noise(), boxes=boxes, box_mask=mask)
    torch.cuda.synchronize()
    same = torch.equal(plain, boxed)
    log(f"  gate 0: the exact video with {TRACKLET_BOXES} boxes against the video without "
        f"the branch, same image and noise: bit for bit {same}")
    if not same:
        raise RuntimeError(f"tracklet at gate 0: the video differs by "
                           f"{(plain - boxed).abs().max().item()}")
    del zero, boxed
    tracklet = branch(TRACKLET_GATE)
    del models
    torch.cuda.empty_cache()
    runs = {"tracklet": ("generate", exact),
            "tracklet_k3": ("generate_k3", dataclasses.replace(exact, uncond_reuse_interval=3)),
            "tracklet_n3k3": ("generate_n3k3", dataclasses.replace(
                exact, deep_cache_interval=3, uncond_reuse_interval=3))}
    launches = {}
    for path, (base, cfg) in runs.items():
        t0 = time.time()
        generate(tracklet, image, cfg, generator=noise(), boxes=boxes, box_mask=mask)
        torch.cuda.synchronize()
        log(f"  {path}: warm-up video {time.time() - t0:.2f} s")
        timed = []
        with calls_by(fa, "flash_attention_fwd", BATCH_AND_LENGTHS) as by_shape:
            for _ in range(GENERATE_TIMED):
                video = None
                reset(counters)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                video = generate(tracklet, image, cfg, generator=noise(), boxes=boxes,
                                 box_mask=mask)
                torch.cuda.synchronize()
                timed.append(time.time() - t0)
        peak = torch.cuda.max_memory_allocated()
        launches[path] = read(counters, [n for n in counters
                                         if n not in BACKWARD_ONLY | OTHER_PATHS])
        want = collections.Counter()
        for batch, kind in unet_schedule(cfg):
            depth = None if kind == "full" else cfg.deep_cache_depth
            for (s, t), n in flash_calls_per_pass(cfg.height, cfg.width, TRACKLET_BOXES,
                                                  depth).items():
                want[(batch * f, s, t)] += n
        got = {k: n / GENERATE_TIMED for k, n in by_shape.items()}
        if got != dict(want):
            raise RuntimeError(f"{path}: flash forward calls per video {got}, the site tables "
                               f"give {dict(want)}")
        forward_per_run(path, by_shape, GENERATE_TIMED, launches[path]["flash_attention_fwd"],
                        ph.fwd_ms["generate"], smi, "video")
        other = {n: c for n, c in launches[path].items() if n != "flash_attention_fwd"}
        if other != {n: c for n, c in gen_launches[base].items() if n != "flash_attention_fwd"}:
            raise RuntimeError(f"{path}: launches {other}, the {base} path's "
                               f"{gen_launches[base]}")
        shape = (1, f, cfg.height, cfg.width, 3)
        if (tuple(video.shape) != shape or not bool(torch.isfinite(video).all())
                or video.min().item() < -1.0 or video.max().item() > 1.0):
            raise RuntimeError(f"{path}: video {tuple(video.shape)} not finite in [-1, 1]")
        log(f"  {path}: flash forward calls per video held to the site tables; every other "
            f"kernel's launches equal the {base} path's; video finite, in [-1, 1]")
        log(f"  [{smi}] {path}: seconds/video {sorted(timed)[len(timed) // 2]:.3f} (median of "
            f"{GENERATE_TIMED}: {', '.join(f'{x:.3f}' for x in timed)}); peak allocated "
            f"{peak / 2**30:.2f} GiB")
    return launches


def tracklet_train_phase(dev, smi, counters, ph: KernelPhase, conv_sums, train_launches):
    """The 'tracklet' scope (TrainConfig(train_mode="tracklet"), the branch at
    gate TRACKLET_GATE, 16 boxes, 512x320x14f, batch 1, remat block): a
    warm-up and TRAIN_STEPS timed steps held to the site tables like the
    temporal step (the flash backward by (S_q, S_kv) to
    FLASH_BWD_SITES['tracklet']), the flash forward twice the temporal
    step's and every other kernel's launches equal to it; the branch's
    masters changed, every other weight bit-identical. Returns the launches
    of the timed steps."""
    import dataclasses

    from svd_xtend_tpu_torch.core.config import TrainConfig, UNetConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels
    from svd_xtend_tpu_torch.train.state import (cast_frozen_to_compute, create_train_state,
                                                 make_train_step)

    cfg = TrainConfig(train_mode="tracklet", tracklet_dim=TRACKLET_DIM,
                      tracklet_gate_init=TRACKLET_GATE)
    unet_cfg = dataclasses.replace(UNetConfig(), tracklet_dim=TRACKLET_DIM,
                                   tracklet_gate_init=TRACKLET_GATE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    t0 = time.time()
    models = SVDModels.create(unet_cfg, device=dev, dtype=torch.float32, generator=gen)
    state = create_train_state(cfg, models)
    cast_frozen_to_compute(models, torch.bfloat16)
    step = make_train_step(models, cfg)
    torch.cuda.synchronize()
    log(f"  models (f32 init, then bf16) and state: {time.time() - t0:.1f} s; "
        f"{len(state.names)} trainable tensors, {sum(p.numel() for p in state.params)} values")
    b, f = cfg.per_device_batch_size, cfg.num_frames
    boxes, mask = seeded_boxes(gen, b, f, cfg.max_boxes, dev)
    batch = {"pixel_values": torch.rand(b, f, cfg.height, cfg.width, 3, device=dev,
                                        generator=gen) * 2 - 1,
             "boxes": boxes, "box_mask": mask}
    draws = torch.Generator(device=dev).manual_seed(SEED + 27)
    t0 = time.time()
    state, m = step(state, batch, generator=draws)
    torch.cuda.synchronize()
    log(f"  warm-up step: {time.time() - t0:.2f} s, loss {m['loss']:.5g}, "
        f"grad_norm {m['grad_norm']:.5g}")
    named = dict(models.unet.named_parameters())
    trained = set(state.names)
    before_train = [p.cpu() for p in state.params]
    before_frozen = {n: p.detach().cpu() for n, p in named.items() if n not in trained}
    state, launches, _, secs, peak = timed_steps("tracklet", "tracklet", step, state, batch,
                                                 draws, counters, ph, smi, cfg, conv_sums)
    bwd = sum(FLASH_BWD_SITES["tracklet"].values()) * TRAIN_STEPS
    want = {n: bwd if n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv") else
            c * (2 if n == "flash_attention_fwd" else 1) for n, c in train_launches.items()}
    if launches != want:
        raise RuntimeError(f"tracklet step: launches {launches}, the temporal step's with the "
                           f"flash forward doubled and the backward pair's per the site "
                           f"tables {want}")
    changed = sum(not torch.equal(p.cpu(), q) for p, q in zip(state.params, before_train))
    moved = [n for n, q in before_frozen.items() if not torch.equal(named[n].cpu(), q)]
    if changed == 0 or moved:
        raise RuntimeError(f"tracklet step: {changed} branch masters changed, frozen weights "
                           f"moved: {moved[:5]}")
    log(f"  {changed}/{len(state.names)} branch masters changed, {len(before_frozen)} other "
        "UNet weights bit-identical; launches: the temporal step's, the flash forward "
        "doubled, the backward pair per FLASH_BWD_SITES['tracklet']")
    log(f"  [{smi}] tracklet scope: seconds/step median {sorted(secs)[len(secs) // 2]:.3f} "
        f"(steps {', '.join(f'{x:.3f}' for x in secs)}); peak allocated {peak / 2**30:.2f} GiB")
    return launches


def tracklet_cli_phase(dev, smi, counters, step_launches):
    """``train.cli --train_mode tracklet`` through main(), in process, over a
    copy of the committed frame folder with a seeded ``boxes.npz`` per video
    (one with a mask, one without), TRACKLET_CLI_STEPS steps at full width:
    launches per step equal the tracklet phase's; params_train.txt names the
    branch alone; tracklet_weights.safetensors holds the branch's flax paths
    and loads into a tracklet UNet. Returns the run's launches."""
    import shutil

    import numpy as np

    from svd_xtend_tpu_torch import native
    from svd_xtend_tpu_torch.core.config import UNetConfig
    from svd_xtend_tpu_torch.data import make_fixtures as fx
    from svd_xtend_tpu_torch.io.convert import is_branch_key, tracklet_state_dict
    from svd_xtend_tpu_torch.io.safetensors_io import load_file
    from svd_xtend_tpu_torch.models.unet import UNetSpatioTemporalConditionModel
    from svd_xtend_tpu_torch.train import cli
    from svd_xtend_tpu_torch.train.checkpoint import TRACKLET_FILE

    root = native.BUILD_DIR.parent / "tracklet_cli"
    shutil.rmtree(root, ignore_errors=True)
    frames = root / "frames"
    shutil.copytree(fx.FRAMES, frames)
    rs = np.random.RandomState(SEED + 28)
    for i, video in enumerate(sorted(os.listdir(frames))):
        n_frames = len([x for x in os.listdir(frames / video) if x.endswith(".jpg")])
        a = rs.uniform(0, 1, (n_frames, 5, 4)).astype(np.float32)
        boxes = np.concatenate([np.minimum(a[..., :2], a[..., 2:]),
                                np.maximum(a[..., :2], a[..., 2:])], -1)
        extra = {"mask": (rs.uniform(0, 1, (n_frames, 5)) > 0.3).astype(np.float32)} if i else {}
        np.savez(frames / video / "boxes.npz", boxes=boxes, **extra)
    val_launches, original = [], cli.run_validation

    def counted_validation(*args, **kwargs):
        before = {n: fn.launches for n, fn in counters.items()}
        original(*args, **kwargs)
        torch.cuda.synchronize()
        val_launches.append({n: fn.launches - before[n] for n, fn in counters.items()})

    out = str(root / "out")
    argv = ["--base_folder", str(frames), "--train_mode", "tracklet", "--learning_rate", "1e-5",
            "--lr_scheduler", "constant", "--max_train_steps", str(TRACKLET_CLI_STEPS),
            "--checkpointing_steps", str(TRACKLET_CLI_STEPS), "--validation_steps", "100",
            "--output_dir", out]
    cli.run_validation = counted_validation
    try:
        reset(counters)
        t0 = time.time()
        stats = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read(counters, [n for n in counters if n not in OTHER_PATHS])
        per_step = {n: (c - sum(v[n] for v in val_launches)) / TRACKLET_CLI_STEPS
                    for n, c in launches.items()}
        want = {n: c / TRAIN_STEPS for n, c in step_launches.items()}
        if per_step != want:
            raise RuntimeError(f"tracklet cli: launches per step {per_step}, the tracklet "
                               f"phase's {want}")
        with open(os.path.join(out, "params_train.txt")) as fh:
            train_names = fh.read().split("\n")
        sd = load_file(os.path.join(out, TRACKLET_FILE))
        with torch.device("meta"):
            unet = UNetSpatioTemporalConditionModel(
                UNetConfig(tracklet_dim=TRACKLET_DIM))
        branch = {k for k in unet.state_dict() if is_branch_key(k)}
        got = tracklet_state_dict(sd)
        if (not all(is_branch_key(n) for n in train_names) or set(train_names) != branch
                or set(got) != branch or any("/" not in k for k in sd)
                or any(got[k].shape != unet.state_dict()[k].shape for k in got)):
            raise RuntimeError("tracklet cli: params_train.txt or the tracklet file is not the "
                               "branch in the JAX package's flat paths")
        size = os.path.getsize(os.path.join(out, TRACKLET_FILE))
        log(f"  tracklet cli: {wall:.1f} s in main() ({TRACKLET_CLI_STEPS} steps, "
            f"{len(val_launches)} validation); launches per step equal the tracklet phase's; "
            f"params_train.txt names the {len(branch)} branch tensors; {TRACKLET_FILE} "
            f"({size} bytes, {len(sd)} flax paths) maps onto the branch of a tracklet UNet")
        log(f"  [{smi}] tracklet cli: host s of each step "
            f"{', '.join(f'{x:.3f}' for x in stats['step_seconds'])}; export "
            f"{stats['export_seconds']:.2f} s")
    finally:
        cli.run_validation = original
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ------------------------------------------------------------ the infer path --

INFER_W, INFER_H = 1024, 576


def infer_kernel_phase(dev, ph: KernelPhase):
    """Each kernel at its 1024x576 L0 shape (generate's CFG batch) and at
    the VAE's, against its plain version: the flash forward (self and gated;
    the plain version on the first two sequences), the frame attention, the
    temporal resnet block, GroupNorm(+SiLU) (UNet L0 and the VAE decoder's
    conv_norm_out), conv3x3 (UNet L0 and the VAE decoder's top), the
    upsample (the UNet's last and the VAE decoder's last) and GEGLU; device
    ms of each in a CUDA graph."""
    from svd_xtend_tpu_torch.ops.kernels import conv3x3 as cv
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
    from svd_xtend_tpu_torch.ops.kernels import geglu as gg
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
    from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr
    from svd_xtend_tpu_torch.ops.kernels import upsample_conv as uc

    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    rn = lambda *s, sc=1.0: (torch.randn(*s, device=dev, generator=g) * sc).to(torch.bfloat16)
    s = (INFER_H // 8) * (INFER_W // 8)
    timed = {}
    for t in (s, s + TRACKLET_BOXES):
        q, k, v = rn(28, s, 320), rn(28, t, 320), rn(28, t, 320)
        run = lambda: fa.flash_attention_packed(q, k, v, num_heads=5, scale=0.125)
        ph.check("flash_attention_fwd", run()[:2], fa.flash_attention_packed_reference(
            q[:2], k[:2], v[:2], num_heads=5, scale=0.125), f"(28, {s}, 320) keys {t} "
            "(first 2 sequences)")
        timed[f"flash forward (28, {s}, 320) keys {t}"] = graph_ms(run)
        del q, k, v
    q, k, v = rn(2, 14, s, 320), rn(2, 14, s, 320), rn(2, 14, s, 320)
    run = lambda: ta.frame_attention(q, k, v, num_heads=5, scale=0.125)
    ph.check("frame_attention_fwd", run(),
             ta.frame_attention_reference(q, k, v, num_heads=5, scale=0.125), f"(2, 14, {s}, 320)")
    timed[f"frame attention (2, 14, {s}, 320)"] = graph_ms(run)
    del q, k, v
    x, t, k1, b1, k2, b2, _, _, w = tresnet_inputs(dev, 2, 14, s, 320, SEED + 30)
    sc, bi = 1 + 0.1 * rn(320).float(), 0.1 * rn(320).float()
    args = (x, t, k1, b1, k2, b2, sc, bi, sc, bi, w)
    run = lambda: tr.temporal_resnet_block(*args, groups=32, eps=1e-5)
    ph.check("temporal_resnet_block", run(), tr.temporal_resnet_reference(*args, 32, 1e-5),
             f"(2, 14, {s}, 320)")
    timed[f"temporal resnet block (2, 14, {s}, 320)"] = graph_ms(run)
    del x, t, args
    for shape, silu, eps in (((28, INFER_H // 8, INFER_W // 8, 320), False, 1e-6),
                             ((8, INFER_H, INFER_W, 128), True, 1e-6)):
        x = rn(*shape) * 3 + 1
        sc, bi = 1 + 0.1 * rn(shape[-1]).float(), 0.1 * rn(shape[-1]).float()
        run = lambda: gn.group_norm_silu(x, sc, bi, groups=32, eps=eps, silu=silu)
        ph.check("group_norm_silu", run(), gn.group_norm_silu_reference(x, sc, bi, 32, eps, silu),
                 f"{shape} silu={silu} ({gn.group_norm_plan(shape, x.dtype, 32).path})")
        timed[f"group_norm_silu {shape}"] = graph_ms(run)
        del x
    for n, h, w_, ci, co, res in ((28, INFER_H // 8, INFER_W // 8, 320, 320, True),
                                  (8, INFER_H, INFER_W, 128, 128, False)):
        x = rn(n, h, w_, ci) * 2 + 0.5
        weight, bias = rn(co, ci, 3, 3, sc=(9 * ci) ** -0.5), 0.1 * rn(co)
        kw = dict(pre_scale=(1 + 0.2 * rn(n, ci)).float() / 2, pre_shift=0.3 * rn(n, ci).float(),
                  pre_silu=True, residual=rn(n, h, w_, co) if res else None)
        run = lambda: cv.conv3x3(x, weight, bias, **kw)
        ph.check("conv3x3", run(), cv.conv3x3_fused_reference(
            x, weight, bias, kw["pre_scale"], kw["pre_shift"], None, kw["residual"], True),
            f"{(n, h, w_, ci, co)} {'preS+res' if res else 'preS'}")
        timed[f"conv3x3 {(n, h, w_, ci, co)}"] = graph_ms(run)
        del x, kw
    for n, h, w_, c in ((28, INFER_H // 16, INFER_W // 16, 640),
                        (8, INFER_H // 2, INFER_W // 2, 256)):
        x, weight, bias = rn(n, h, w_, c), rn(c, c, 3, 3, sc=(9 * c) ** -0.5), 0.1 * rn(c)
        run = lambda: uc.upsample_conv(x, weight, bias)
        ph.check("upsample_conv", run(), uc.upsample2x_conv3x3_reference(x, weight, bias),
                 f"{(n, h, w_, c)}")
        timed[f"upsample_conv {(n, h, w_, c)}"] = graph_ms(run)
        del x
    c = 320
    gargs = [rn(28 * s, c), 1 + 0.1 * rn(c), 0.1 * rn(c), rn(8 * c, c, sc=c ** -0.5),
             0.1 * rn(8 * c), rn(c, 4 * c, sc=(4 * c) ** -0.5), 0.1 * rn(c)]
    run = lambda: gg.ln_geglu_residual(*gargs)
    ph.check("geglu_fwd", run(), gg.ln_geglu_residual_reference(*gargs), f"T {28 * s} C {c}")
    timed[f"geglu T {28 * s} C {c}"] = graph_ms(run)
    del gargs
    log("  device ms per launch in a CUDA graph at 1024x576: "
        + "; ".join(f"{k} {v:.4f}" for k, v in timed.items()))


def infer_phase(dev, smi, counters):
    """The inference entry at its defaults (1024x576, 14 frames, 30 steps),
    run as ``python -m svd_xtend_tpu_torch.scripts.infer_svd`` runs it (runpy,
    in process, so the counters see its launches), on a committed frame,
    with 16 ``--boxes``, a random-weight pipeline directory, a LoRA file and a
    tracklet file, each written with the port's own exporters: the flash
    forward's launches by (batch, S_q, S_kv) held to 30 CFG passes x
    flash_calls_per_pass; the mp4 and the GIF hold 14 frames, the video is
    finite; generate's s/video (the first at this size in the process) and
    the entry point's wall time, peak memory. Returns the launches."""
    import runpy
    import shutil

    import numpy as np

    from svd_xtend_tpu_torch import native
    from svd_xtend_tpu_torch.core.config import PipelineConfig
    from svd_xtend_tpu_torch.data import make_fixtures as fx
    from svd_xtend_tpu_torch.diffusion import pipeline
    from svd_xtend_tpu_torch.io.safetensors_io import save_file
    from svd_xtend_tpu_torch.models import lora as lora_lib
    from svd_xtend_tpu_torch.ops.kernels import flash_attention as fa
    from svd_xtend_tpu_torch.train.checkpoint import (export_lora_diffusers, export_tracklet,
                                                      export_unet_diffusers)

    root = native.BUILD_DIR.parent / "infer_smoke"
    shutil.rmtree(root, ignore_errors=True)
    pipe = root / "pipeline"
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    t0 = time.time()
    models = pipeline.SVDModels.create(device=dev, dtype=torch.bfloat16, generator=gen)
    export_unet_diffusers(models.unet, str(pipe / "unet"))
    for comp, sub, name in (("vae", "vae", "diffusion_pytorch_model.safetensors"),
                            ("clip", "image_encoder", "model.safetensors")):
        os.makedirs(pipe / sub)
        save_file(getattr(models, comp).state_dict(), str(pipe / sub / name),
                  metadata={"format": "pt"})
    branch = models.with_tracklet(TRACKLET_DIM, TRACKLET_HEADS, gate_init=TRACKLET_GATE,
                                  generator=torch.Generator(dev).manual_seed(SEED + 32))
    export_tracklet(branch.unet, str(root / "tracklet"))
    adapter = lora_lib.init(branch.unet, generator=gen)
    for ab in adapter.values():
        ab["b"].normal_(0.0, LORA_B_STD, generator=gen)
    export_lora_diffusers(adapter, str(root / "lora"))
    del models, branch, adapter
    torch.cuda.empty_cache()
    size = sum(p.stat().st_size for p in root.rglob("*") if p.is_file())
    log(f"  files written with the port's exporters ({size} bytes): a pipeline directory, "
        f"a LoRA file, a tracklet file, in {time.time() - t0:.1f} s")

    rs = np.random.RandomState(SEED + 33)
    a = rs.uniform(0, 1, (TRACKLET_BOXES, 4))
    boxes = np.concatenate([np.minimum(a[:, :2], a[:, 2:]), np.maximum(a[:, :2], a[:, 2:])], 1)
    out = root / "generated.mp4"
    argv = ["--image", fx.reference_paths()[0], "--model_path", str(pipe),
            "--lora_path", str(root / "lora"), "--tracklet_path", str(root / "tracklet"),
            "--boxes", json.dumps(np.round(boxes, 4).tolist()), "--out", str(out)]
    videos, seconds, original = [], [], pipeline.generate

    def timed_generate(*args, **kwargs):
        t0 = time.time()
        video = original(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        videos.append(video)
        return video

    saved_argv = sys.argv
    pipeline.generate = timed_generate
    try:
        reset(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with calls_by(fa, "flash_attention_fwd", BATCH_AND_LENGTHS) as by_shape:
            sys.argv = ["svd_xtend_tpu_torch.scripts.infer_svd", *argv]
            runpy.run_module("svd_xtend_tpu_torch.scripts.infer_svd", run_name="__main__",
                             alter_sys=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        sys.argv = saved_argv
        pipeline.generate = original
    peak = torch.cuda.max_memory_allocated()
    launches = read(counters, [n for n in counters
                               if n not in BACKWARD_ONLY | OTHER_PATHS])
    cfg = PipelineConfig(height=INFER_H, width=INFER_W, num_inference_steps=30)
    want = collections.Counter()
    for batch, _ in unet_schedule(cfg):
        for (s, t), n in flash_calls_per_pass(INFER_H, INFER_W, TRACKLET_BOXES).items():
            want[(batch * cfg.num_frames, s, t)] += n
    if dict(by_shape) != dict(want):
        raise RuntimeError(f"infer: flash forward calls {dict(by_shape)}, the site tables give "
                           f"{dict(want)}")
    check_upsample("infer", launches, upsample_launches(cfg))
    video = videos[-1]
    shape = (1, cfg.num_frames, INFER_H, INFER_W, 3)
    if len(videos) != 1 or tuple(video.shape) != shape or not bool(torch.isfinite(video).all()):
        raise RuntimeError(f"infer: {len(videos)} videos, {tuple(video.shape)}, finite "
                           f"{bool(torch.isfinite(video).all())}")
    import cv2
    from PIL import Image
    cap = cv2.VideoCapture(str(out))
    n_mp4 = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    with Image.open(str(out).replace(".mp4", ".gif")) as gif:
        n_gif, gif_size = gif.n_frames, gif.size
    if n_mp4 != cfg.num_frames or n_gif != cfg.num_frames or gif_size != (INFER_W, INFER_H):
        raise RuntimeError(f"infer: the mp4 holds {n_mp4} frames, the GIF {n_gif} at {gif_size}")
    log(f"  infer: flash forward calls by (batch, S_q, S_kv) held to the site tables "
        f"({sum(want.values())} a video); {out.name} {n_mp4} frames, GIF {n_gif} frames "
        f"{gif_size[0]}x{gif_size[1]}; video {tuple(video.shape)} finite, std "
        f"{video.std().item():.4f}")
    log(f"  [{smi}] infer (1024x576, 14 frames, 30 steps, 16 boxes, LoRA + tracklet files): "
        f"generate {seconds[0]:.3f} s/video (the first at this size in the process); the entry "
        f"point {wall:.1f} s with building, loading and writing; peak allocated "
        f"{peak / 2**30:.2f} GiB")
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ------------------------------------------------------------ the optim8 path --

OPTIM8_SHAPES = [(1280, 5120), (640, 640, 3, 3), (2047, 3), (4096,), (4095,), (320,)]
OPTIM8_STEPS = 3
# the share of int8 codes the card's 8-bit AdamW may hold apart from the CPU
# run's after OPTIM8_STEPS steps on the same gradients (each by one code):
# a value that lands within an f32 ulp of a rounding boundary may round the
# other way where the two libraries' pow or sqrt differ in the last bit
OPTIM8_CODE_SHARE = 1e-4


def optim8_phase(dev, smi, counters):
    """One full-scope step (warm-up) and a timed one with ``use_8bit_adam``,
    then with ``grad_dtype="bf16"``, at 512x320x14f: s/step, peak memory
    (the fp32 full-scope step: the train phase's), the moments' bytes; then
    AdamW8bit on the card and on the CPU over OPTIM8_STEPS seeded gradient
    steps of a mixed tree (tensors over and under 4096 values): the int8
    codes apart in at most OPTIM8_CODE_SHARE of the values, each by one,
    the scales and f32 moments within 1e-6 relative. Returns the timed
    steps' launches."""
    import dataclasses

    from svd_xtend_tpu_torch.core.config import TrainConfig
    from svd_xtend_tpu_torch.diffusion.pipeline import SVDModels
    from svd_xtend_tpu_torch.io.convert import flax_axes
    from svd_xtend_tpu_torch.train.quant import AdamW8bit, Quantized
    from svd_xtend_tpu_torch.train.state import (cast_frozen_to_compute, create_train_state,
                                                 make_train_step)

    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    models = SVDModels.create(device=dev, dtype=torch.float32, generator=gen)
    base = TrainConfig(train_mode="full")
    batch = torch.rand(1, base.num_frames, base.height, base.width, 3, device=dev,
                       generator=gen) * 2 - 1
    draws = torch.Generator(device=dev).manual_seed(SEED + 35)
    launches = collections.Counter()
    for name, cfg in (("use_8bit_adam", dataclasses.replace(base, use_8bit_adam=True)),
                      ("grad_dtype bf16", dataclasses.replace(base, grad_dtype="bf16"))):
        state = create_train_state(cfg, models)
        cast_frozen_to_compute(models, torch.bfloat16)
        step = make_train_step(models, cfg)
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for i in range(2):
            if i == 1:
                reset(counters)
            t0 = time.time()
            state, m = step(state, batch, generator=draws)
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
            if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
                raise RuntimeError(f"optim8 {name}: non-finite metrics {m}")
        launches.update(read(counters, [n for n in counters if n not in OTHER_PATHS]))
        peak = torch.cuda.max_memory_allocated()
        n = sum(p.numel() for p in state.params)
        moments = (state.optimizer.adamw8.moment_bytes() if cfg.use_8bit_adam else
                   sum(v.numel() * v.element_size() for s in state.optimizer.adamw.state.values()
                       for v in s.values() if v.dim()))
        log(f"  [{smi}] optim8 {name}: full scope ({n} values), the first step {secs[0]:.2f} s "
            f"(first of its optimizer), the second {secs[1]:.2f} s, loss {m['loss']:.5g}; "
            f"moments {moments} bytes ({moments / (8 * n):.3f} of f32's); peak allocated "
            f"{peak / 2**30:.2f} GiB")
        del state, step
        torch.cuda.empty_cache()
    del models, batch
    torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(SEED + 36)
    params = [torch.randn(s, generator=g) * 0.05 for s in OPTIM8_SHAPES]
    grads = [[torch.randn(s, generator=g) * 10.0 ** (-i - 2) for s in OPTIM8_SHAPES]
             for i in range(OPTIM8_STEPS)]
    # blocks cut in each tensor's JAX order: a Linear's (out, in) as (in,
    # out), a conv's OIHW as HWIO
    axes = [flax_axes(f"t{i}.weight", len(s)) for i, s in enumerate(OPTIM8_SHAPES)]
    opts = {d: AdamW8bit([p.clone().to(d) for p in params], axes=axes) for d in ("cpu", dev)}
    for i in range(OPTIM8_STEPS):
        for d, opt in opts.items():
            opt.step([x.to(d) for x in grads[i]], 1e-3)
    host, card_ = opts["cpu"], opts[dev]
    codes, apart, worst, rel = 0, 0, 0, 0.0
    for mh, mc in zip(host.mu + host.nu, card_.mu + card_.nu):
        if isinstance(mh, Quantized):
            d = (mh.q.int() - mc.q.cpu().int()).abs()
            codes += d.numel()
            apart += int((d > 0).sum())
            worst = max(worst, int(d.max()))
            rel = max(rel, ((mh.scale - mc.scale.cpu()).abs() / mh.scale.abs().clamp_min(1e-30)
                            ).max().item())
        else:
            rel = max(rel, ((mh - mc.cpu()).abs() / mh.abs().clamp_min(1e-30)).max().item())
    pdiff = max((a - b.cpu()).abs().max().item() for a, b in zip(host.params, card_.params))
    for k, (shape, ax) in enumerate(zip(OPTIM8_SHAPES, axes)):
        m = card_.mu[k]
        if isinstance(m, Quantized):
            log(f"  optim8: {shape} blocked in the order {ax or 'as stored'}: first moment's "
                f"block 0 codes {m.q[0, :8].tolist()} (CPU {host.mu[k].q[0, :8].tolist()}), "
                f"{m.q.shape[0]} blocks, scales {m.scale[:3, 0].tolist()}")
    log(f"  optim8: AdamW8bit on the card against the CPU after {OPTIM8_STEPS} steps on "
        f"{OPTIM8_SHAPES}: {apart} of {codes} int8 codes apart (at most {worst}; bound "
        f"{OPTIM8_CODE_SHARE} of them, each by 1), scales and f32 moments within {rel:.3g} "
        f"relative, parameters within {pdiff:.3g}")
    if apart > OPTIM8_CODE_SHARE * codes or worst > 1 or rel > 1e-6:
        raise RuntimeError(f"optim8: card and CPU int8 moments differ: {apart} codes, worst "
                           f"{worst}, relative {rel}")
    return dict(launches)


# the port's own kernels: the __global__ functions of csrc/*.cu, by their
# unqualified names
HAND_KERNELS = frozenset({"flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                          "frame_attention_kernel", "ln_kernel", "sm90_gemm::gemm_kernel",
                          "sm90_gemm::reduce_kernel", "affine_silu::kernel",
                          "gn_stats::stats_kernel", "gn_stats::fold_kernel",
                          "gn_cluster::cluster_kernel", "conv3x3_kernel"})


def kernel_base_name(name: str) -> str:
    """'void (anonymous namespace)::affine_silu::kernel<true>(...)' ->
    'affine_silu::kernel'; names in a named namespace keep it ('at::native::...')."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.match(r"[\w:]*", name).group(0)


def kernel_kind(name: str) -> str:
    if kernel_base_name(name) in HAND_KERNELS:
        return "hand kernels"
    if "f32f32" in name or "sgemm" in name:
        return "f32 GEMMs (plain backwards)"
    if "fprop" in name or "dgrad" in name or "wgrad" in name or "conv" in name.lower():
        return "cuDNN convs"
    if "gemm" in name.lower() or "cutlass" in name or "nvjet" in name:
        return "bf16 GEMMs (cuBLAS)"
    return "elementwise/reduce/copy"


def step_breakdown(trace_path: str) -> None:
    """Device time of one traced train step by phase (from the labels of
    train/state.py, diffusion/training.py and models/unet.py: a kernel is
    charged to the label range its launch falls in) and by kind."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    labels = [e for e in events if e.get("cat") == "user_annotation"]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    span = max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)

    def inside(name, ts):
        return any(e["name"] == name and e["ts"] <= ts <= e["ts"] + e["dur"] for e in labels)

    table = {}
    for e in kernels:
        ts = launch.get(e["args"].get("correlation"), e["ts"])
        if inside("train.backward", ts):
            phase = "recompute" if inside("unet.checkpointed_block", ts) else "backward"
        elif inside("train.optimizer", ts):
            phase = "optimizer"
        elif inside("train.encode", ts):
            phase = "encode (VAE, CLIP)"
        elif inside("train.unet_loss", ts):
            phase = "forward"
        else:
            phase = "other"
        key = (phase, kernel_kind(e["name"]))
        table[key] = table.get(key, 0.0) + e["dur"] / 1e3
    busy = sum(table.values())
    log(f"  traced step: device span {span / 1e3:.1f} ms, kernels busy {busy:.1f} ms "
        f"(idle {100 * (1 - busy * 1e3 / span):.1f} % under the profiler)")
    for phase in ("encode (VAE, CLIP)", "forward", "recompute", "backward", "optimizer",
                  "other"):
        rows = {k: v for (p, k), v in table.items() if p == phase}
        if rows:
            parts = ", ".join(f"{k} {v:.1f}" for k, v in sorted(rows.items(), key=lambda r: -r[1]))
            log(f"    {phase}: {sum(rows.values()):.1f} ms ({parts})")


def profile_step(step, state, batch, draws, out_dir):
    """torch.profiler over one train step: the table by device time and the
    Chrome trace into out_dir, and the breakdown by phase and kind."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, generator=draws)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60)
    with open(os.path.join(out_dir, "train_step_profile.txt"), "w") as fh:
        fh.write(table)
    trace = os.path.join(out_dir, "train_step_trace.json")
    prof.export_chrome_trace(trace)
    log(f"  profile of one train step written to {out_dir}")
    step_breakdown(trace)


if __name__ == "__main__":
    sys.exit(main())
