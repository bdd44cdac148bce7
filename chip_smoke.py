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
     train step; at the UNet levels (and the VAE decoder's top) the block's
     device time split into norm1's fold, the kernels (with their prologue
     passes) and norm2's fold, and its host ms; the GroupNorm fold's kernels
     (group_norm_fold, fold_from_partials) against their plain versions.
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
  3c. probe kernels: the kernels of the TPU probe scripts against their plain
     versions: the four softmax organisations of the flash forward
     (flash_variants) at the variants probe's shapes, (140, 2560) whole (also
     each mode's device time in a CUDA graph beside SDPA's) and
     (280, 2304), (250, 9216) on their first 8 heads (the plain version of
     those would hold ~85 GB of f32 scores), nosoftmax on positive inputs;
     the head-sliced forward with its LSE at the head-slice probe's shapes;
     the bf16 and int8 chains at the int8 probe's tiles for 1, 2 and 4 steps
     (int8 bit for bit), timed at 60. Each timed beside its bound, plain
     version and library call (SDPA; none for the chains).
  4. whole UNet: full SVD widths on a 2-frame 16x16 latent (all kernels
     engage), bf16 with the kernels on the card against f32 with the plain
     versions on the host CPU, from the same seeded weights: the forward
     output, then the gradient of edm_denoising_loss (fixed draws) with
     respect to the temporal-scope parameters, also against the card's bf16
     plain path (ops/kernels/dispatch.plain_versions); then the same for
     the gradient with respect to a LoRA adapter on every attention
     projection (seeded nonzero B, remat "block").
  5. generate (the serving path): ``generate`` at the default PipelineConfig
     (512x320, 14 frames, 25 Euler steps, stacked CFG, decode chunks of 8)
     with the full UNet, VAE and CLIP in bf16 from seeded random weights,
     batch 1, GEGLU kernel on: one warm-up run, then 3 timed runs (the
     median s/video is reported, beside each run's and the device memory
     segments the allocator added during it); the last run's forward-kernel
     launch counts must all be > 0; the flash forward's, GEGLU's, the
     temporal resnet's, the frame attention's and GroupNorm's launches per
     video by shape (the exact video's temporal resnet and GroupNorm
     launches held against TRESNET_SITES and GN_SITES), and their sums of
     launches x the kernel phases' device ms at each shape.
  6. train (this slice's main path): the default TrainConfig (temporal
     scope, 512x320x14f, batch 1, remat "block", AdamW with f32 masters,
     bf16 compute) through make_optimizer/create_train_state/make_train_step
     on a seeded synthetic batch in [-1, 1]: one warm-up step, then 3 timed
     steps whose launch counts of every kernel (forward and flash backward)
     must all be > 0; finite loss and grad_norm, trainable weights changed,
     frozen ones bit-identical; s/step and peak memory; the flash backward
     pair's, the flash forward's, GEGLU's, the temporal resnet's, the frame
     attention's and GroupNorm's launches per step by level (the flash
     backward's held against FLASH_BWD_SITES, the temporal resnet's and
     GroupNorm's against TRESNET_SITES and GN_SITES, conv3x3's and dU's
     against the conv site tables), and their sums of launches x the kernel
     phases' device ms at that level. Then one full-scope step at the same
     size: finite loss, peak memory.
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
     blocked, checkpoint bytes and save/restore s, validation s, peak
     memory and the val/* metrics, beside the card's name and power limit.
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
import sys
import time

import torch
import torch.nn.functional as F

from svd_xtend_tpu_torch.scripts import card, cuda_ms, graph_ms
from svd_xtend_tpu_torch.scripts.sites import (FLASH_BWD_SITES, GEGLU_SHAPES, GN_SITES,
                                               TRESNET_SITES, UNET_CONV_SITES,
                                               UNET_DGRAD_SITES, VAE_DECODE_SITES,
                                               VAE_ENCODE_SITES)

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
GENERATE_TIMED = 3


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
        self.bwd_ms = {}    # tokens S -> device (dQ ms, dK/dV ms) at the train step's shape
        # path ("generate": no LSE, "train": with it) -> {(batch, tokens S): forward device ms}
        self.fwd_ms = {"generate": {}, "train": {}}
        self.geglu_ms = {}      # (T, C) -> device ms per launch
        self.tresnet_ms = {}    # x's shape (B, F, S, C) -> device (conv_a ms, conv_b ms)
        self.frame_ms = {}      # q's shape (B, F, S, H*64) -> frame attention device ms
        self.gn_ms = {}         # (x's shape, silu) -> group_norm_silu device ms

    def forward_level(self, path, b, s, h, run, sdpa, moved):
        """The flash forward at one (batch, tokens, heads): host loop and
        device time in a CUDA graph beside SDPA's device time and the bound;
        the device time prices the path's launches at that shape."""
        flops = 4 * b * h * s * s * 64
        host, dev_ms, sdpa_ms = cuda_ms(run), graph_ms(run), graph_ms(sdpa)
        b_ms, b_by = bound_ms(flops, moved)
        self.fwd_ms[path][(b, s)] = dev_ms
        if (path, b, s) == ("generate", 28, 2560):     # the kernels line's shape
            self.times["flash_attention_fwd"]["device_ms"] = dev_ms
        log(f"  flash forward {path} {(b, s, h * 64)} heads {h}: {host:.4f} ms, device "
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
    seeds at the 560-row level, and the GroupNorm fold's kernels."""
    from svd_xtend_tpu_torch.ops import video
    from svd_xtend_tpu_torch.ops.kernels import gemm_plan
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr
    log("  x (B, F, S, C) x launches per video / per step: device ms conv_a / conv_b / "
        "F.conv2d alone / bound, TFLOP/s of conv_a, conv_b; the plan")
    totals = collections.defaultdict(float)
    for b, f, s, c, per_video, per_step in TRESNET_SITES:
        x, t, k1, b1, k2, b2, sc1, sh1, w = tresnet_inputs(dev, b, f, s, c, SEED + 10)
        (wt1, b1f), (wt2, b2f) = tr.packed(k1, b1), tr.packed(k2, b2)
        label = f"{(b, f, s, c)}"
        run_a = lambda: tr.conv_a(x, wt1, b1f, sc1, sh1, t)
        plain_a = lambda: tr.conv_a_reference(x, k1, b1, sc1, sh1, t)
        h, psum, psq = run_a()
        rh, rsum, rsq = plain_a()
        ph.check("temporal_resnet_conv_a", h, rh, label)
        readings = check_tresnet_stats(label, (x, k1, b1, sc1, sh1, t), h, psum, psq, rh, rsum, rsq)
        log(f"    channel sums against conv_a_reference's {readings[0]:.3g}, truncated-h "
            f"control {readings[1]:.3g} (bound {tr.sums_tolerance(f * s):.3g}); slots against "
            f"the stored h's {readings[2]:.3g}, pre-rounding control {readings[3]:.3g} "
            f"(bound {SLOT_BOUND})")
        run_b = lambda: tr.conv_b(rh, wt2, b2f, sc1, sh1, x, w)
        plain_b = lambda: tr.conv_b_reference(rh, k2, b2, sc1, sh1, x, w)
        out = run_b()
        ph.check("temporal_resnet_conv_b", out, plain_b(), label)
        again = (*run_a(), run_b())
        if not all(torch.equal(u, v) for u, v in zip((h, psum, psq, out), again)):
            raise RuntimeError(f"temporal resnet {label}: two runs differ")
        g = torch.Generator(device=dev).manual_seed(SEED + 12)
        sc, bi = 1 + 0.1 * torch.randn(c, device=dev, generator=g), 0.1 * torch.randn(
            c, device=dev, generator=g)
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
            tresnet_block_parts(label, x, sc, bi, sc1, sh1, psum, psq, a_ms, b_ms, block)
        del x, h, rh, out, again, u
    for path in ("exact video", "train step"):
        a, b_, lib, bound = (totals[path, k] for k in ("a", "b", "conv2d", "bound"))
        log(f"  [{smi}] temporal resnet per {path}: launches x device ms, conv_a {a:.1f} + "
            f"conv_b {b_:.1f} = {a + b_:.1f} ms; F.conv2d alone (both convs) {lib:.1f}; "
            f"bound {bound:.1f}")
    tresnet_sums_seeds(dev)
    fold_phase(dev, ph)


SLOT_BOUND = 1e-5   # kernel A's partials against the plain statistics of its own h


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
            got, ref = tr.conv_a(x, wt1, b1f, sc1, sh1, t), tr.conv_a_reference(*a_args)
            readings.append(check_tresnet_stats(f"{(b, f, s, c)} seed {i}", a_args, *got, *ref))
        log(f"    {(b, f, s, c)} over {seeds} seeds: channel sums against conv_a_reference's "
            f"at most {max(r[0] for r in readings):.3g}, truncated-h control at least "
            f"{min(r[1] for r in readings):.3g} (bound {tr.sums_tolerance(f * s):.3g}); slots "
            f"at most {max(r[2] for r in readings):.3g}, pre-rounding control at least "
            f"{min(r[3] for r in readings):.3g} (bound {SLOT_BOUND})")


def tresnet_block_parts(label, x, sc, bi, sc1, sh1, psum, psq, a_ms, b_ms, block):
    """The block's device ms in a CUDA graph and its parts: norm1's fold, the
    prologue pass (twice in the block, inside each kernel's time), kernels A
    and B, norm2's fold from A's statistics (the weights are packed once per
    parameter version, nothing per call); and the block's host ms per call
    (enqueue, no synchronise)."""
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr

    f, s = x.shape[1], x.shape[2]
    fold1 = graph_ms(lambda: gn.group_norm_fold(x, sc, bi, groups=32, eps=1e-5))
    fold2 = graph_ms(lambda: gn.fold_from_partials(psum, psq, f * s, sc, bi, 32, 1e-5))
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
        f"(prologue {prologue:.4f} of it) + fold2 {fold2:.4f} + conv_b {b_ms:.4f} (+ prologue) "
        f"+ weights 0 (packed once per version); host {host:.4f} ms a call (enqueue)")


def fold_phase(dev, ph: KernelPhase):
    """The GroupNorm fold's kernels (csrc/gn_fold.cu) at the L0 temporal
    block's x (2, 14, 2560, 320): group_norm_fold (statistics pass and fold)
    against its plain version, its partials slot by slot against
    channel_stats_reference (1e-5 relative), and fold_from_partials from
    them against the plain fold of their slot sums; sc, sh within 1e-4
    (f32 sums in another order, E[x^2] - mean^2 as the JAX formula). Each
    timed beside its plain version and the bound (inputs read once, outputs
    written once; the partials between the two passes are scratch)."""
    from svd_xtend_tpu_torch.ops.kernels import groupnorm as gn

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    x = (torch.randn(2, 14, 2560, 320, device=dev, generator=g) * 2 + 0.5).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(320, device=dev, generator=g)
    bias = 0.1 * torch.randn(320, device=dev, generator=g)
    rows = 14 * 2560
    psum = torch.empty(2, gn.stats_slots(rows), 320, device=dev)
    psq = torch.empty_like(psum)
    gn._fold_launch(x, psum, psq, rows, scale, bias, 32, 1e-5)
    for got, ref in zip((psum, psq), gn.channel_stats_reference(x.reshape(-1, 320), rows)):
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        log(f"  fold statistics partials: max rel err {rel:.3g} (bound 1e-5)")
        if not bool(torch.isfinite(got).all()) or rel > 1e-5:
            raise RuntimeError(f"group_norm_fold: partials off by {rel}")
    cases = (("group_norm_fold", lambda: gn.group_norm_fold(x, scale, bias, groups=32, eps=1e-5),
              lambda: gn.group_norm_fold_reference(x, scale, bias, groups=32, eps=1e-5),
              nbytes(x)),
             ("fold_from_partials",
              lambda: gn.fold_from_partials(psum, psq, rows, scale, bias, 32, 1e-5),
              lambda: gn.fold_from_channel_sums(psum.sum(1), psq.sum(1), rows, scale, bias, 32,
                                                1e-5),
              nbytes(psum, psq)))
    for name, run, plain, moved in cases:
        err = 0.0
        for got, ref in zip(run(), plain()):
            err = max(err, (got - ref).abs().max().item())
            if not bool(torch.isfinite(got).all()) or not torch.allclose(got, ref, 1e-4, 1e-4):
                raise RuntimeError(f"{name}: error {err}")
        ph.err[name] = err
        ph.time(name, run, plain, 0, moved + 2 * 2 * 320 * 4)      # + sc, sh
        ph.times[name]["device_ms"] = graph_ms(run)
        log(f"    {name}: max_abs_err {err:.4g} (allclose 1e-4), device "
            f"{ph.times[name]['device_ms']:.4f} ms")
    # the folds of ResnetBlock2D (conv3x3's pre-affine): the UNet's L0 norm1
    # at CFG batch and the VAE decoder's top resnet
    for shape in ((28, 40, 64, 320), (8, 320, 512, 128)):
        x = (torch.randn(*shape, device=dev, generator=g) * 2 + 0.5).to(torch.bfloat16)
        c = shape[-1]
        scale, bias = scale[:c], bias[:c]
        run = lambda: gn.group_norm_fold(x, scale, bias, groups=32, eps=1e-5)
        plain = lambda: gn.group_norm_fold_reference(x, scale, bias, groups=32, eps=1e-5)
        for got, ref in zip(run(), plain()):
            if not torch.allclose(got, ref, 1e-4, 1e-4):
                raise RuntimeError(f"group_norm_fold {shape}: off")
        log(f"    group_norm_fold {shape}: device {graph_ms(run):.4f} ms, plain "
            f"{graph_ms(plain):.4f} ms, bound {bound_ms(0, nbytes(x))[0]:.4f} ms (bytes)")
        del x


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

    log("kernels: flash attention forward with LSE and backward (training batch 14 frames)")
    for b, s_len, h in [(14, 2560, 5), (14, 640, 10), (14, 160, 20), (14, 40, 20)]:
        q, k, v, do = (rn(b, s_len, h * 64) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, h, 0.125)
        ref_o, ref_lse = fa.flash_attention_fwd_reference(q, k, v, h, 0.125)
        ph.check("flash_attention_fwd", o, ref_o, f"{(b, s_len, h * 64)} heads {h}")
        lerr = (lse - ref_lse).abs().max().item()
        log(f"  flash LSE {(b, s_len, h)}: max_abs_err {lerr:.3g} (bound {LSE_ATOL})")
        if not bool(torch.isfinite(lse).all()) or lerr > LSE_ATOL:
            raise RuntimeError(f"flash LSE error {lerr}")
        heads = lambda a: a.view(b, s_len, h, 64).transpose(1, 2)
        ph.forward_level("train", b, s_len, h, lambda: fa.flash_attention_fwd(q, k, v, h, 0.125),
                         lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                                scale=0.125),
                         nbytes(q, k, v, q, lse))
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
        label = f"{(b, s_len, h * 64)} heads {h}"
        ph.check_grad("flash_attention_bwd_dq", dq, pq, rq, label + " dQ")
        ph.check_grad("flash_attention_bwd_dkv", dk, pk, rk, label + " dK")
        ph.check_grad("flash_attention_bwd_dkv", dv, pv, rv, label + " dV")
        del grads, pq, pk, pv, rq, rk, rv
        run_dq = lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, h, 0.125)
        run_dkv = lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, h, 0.125)
        mm = 2 * b * h * s_len * s_len * 64     # one product's FLOPs
        stats = 2 * b * h * s_len * 4           # LSE and delta, f32
        work = {"dQ": (3, nbytes(q, k, v, do, q) + stats),
                "dK/dV": (4, nbytes(q, k, v, do, k, v) + stats)}
        if s_len == 2560:
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
        ph.bwd_ms[s_len] = (graph_ms(run_dq), graph_ms(run_dkv))
        for (name, (n_mm, moved)), k_ms, d_ms in zip(work.items(), ms, ph.bwd_ms[s_len]):
            b_ms, b_by = bound_ms(n_mm * mm, moved)
            log(f"  flash backward {name} {label}: {k_ms:.4f} ms, device {d_ms:.4f} ms; "
                f"{n_mm * mm / d_ms / 1e9:.1f} TFLOP/s executed on its {n_mm} products "
                f"(device); bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / d_ms:.1f} % of it")
        del q, k, v, do, o, ref_o, dq, dk, dv
    return ph


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

    log("kernels: QK.PV chains, bf16 and int8 with dynamic quantisation (int8: bit for bit)")
    ph.err["chain_int8_qd"] = 0.0
    for bq, bkm in pi8.TILES:
        q, kT, v, kTi, vi = pi8.inputs(bq, bkm, SEED)
        for n in (1, 2, 4):
            label = f"bq {bq} bkm {bkm} steps {n}"
            ph.check("chain_bf16", fc.chain_bf16(q, kT, v, n),
                     fc.chain_bf16_reference(q, kT, v, n), label)
            got, ref = fc.chain_int8_qd(q, kTi, vi, n), fc.chain_int8_qd_reference(q, kTi, vi, n)
            torch.cuda.synchronize()
            log(f"  chain_int8_qd {label}: bit-identical {torch.equal(got, ref)}, "
                f"max |out| {ref.abs().max().item():.4g}")
            if not torch.equal(got, ref):
                raise RuntimeError(f"chain_int8_qd {label}: differs from its plain version by "
                                   f"{(got - ref).abs().max().item()}")
        if (bq, bkm) == (1280, 1280):
            n = pi8.N_INNER
            ops = n * 4 * bq * 64 * bkm     # dependent steps: a latency chain
            ph.time("chain_bf16", lambda: fc.chain_bf16(q, kT, v, n),
                    lambda: fc.chain_bf16_reference(q, kT, v, n), ops,
                    nbytes(q, kT, v) + bq * 64 * 4, label=f"bq {bq} bkm {bkm} steps {n}")
            ph.time("chain_int8_qd", lambda: fc.chain_int8_qd(q, kTi, vi, n),
                    lambda: fc.chain_int8_qd_reference(q, kTi, vi, n), ops,
                    nbytes(q, kTi, vi) + bq * 64 * 4, label=f"bq {bq} bkm {bkm} steps {n}",
                    peak=PEAK_INT8_OPS)


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
    _build.library()
    log(f"build: {time.time() - t0:.1f} s -> {_build.library_path().name}")

    ph = kernel_phases(dev)
    torch.cuda.empty_cache()
    log("kernels: temporal resnet A and B at every site of the exact video and the train step")
    tresnet_phase(dev, ph, smi)
    torch.cuda.empty_cache()
    conv_sums = conv_phase(dev, ph, smi)
    flash_bshd_phase(dev, ph)
    torch.cuda.empty_cache()
    probe_kernel_phase(dev, ph)
    torch.cuda.empty_cache()

    log("whole UNet: full widths, card bf16 kernels vs host f32 plain (output, gradient)")
    whole_unet_phase(dev)
    torch.cuda.empty_cache()

    counters = kernel_counters()
    log("generate: PipelineConfig() with full UNet/VAE/CLIP, bf16, all kernels on; then "
        "the CFG cache (k3) and DeepCache + CFG cache (n3 k3)")
    gen_launches = generate_phase(dev, smi, counters, ph)
    torch.cuda.empty_cache()

    log("train: default TrainConfig (temporal scope, 512x320x14f, batch 1, remat block)")
    train_launches = train_phase(dev, smi, counters, args.profile, ph, conv_sums)
    torch.cuda.empty_cache()

    log("lora: TrainConfig(train_mode='lora') (rank 4, alpha 4, 512x320x14f, batch 1, remat "
        "block); export, read back, merge, an exact video; the VAE as a sharded component")
    lora_launches = lora_phase(dev, smi, counters, ph, conv_sums, gen_launches["generate"])
    torch.cuda.empty_cache()

    log("cli: the training CLI (train/cli.py) at 512x320x14f, temporal scope, bf16, remat "
        "block, over the committed frame folder: straight, then resumed from checkpoint-2")
    cli_launches = cli_phase(dev, smi, counters, gen_launches["generate"], train_launches)
    torch.cuda.empty_cache()

    log("mha: the head-major attention entry point at the UNet's L0 shape")
    mha_launches = mha_phase(dev, counters)
    torch.cuda.empty_cache()

    log("probes: the three probe scripts at their shapes")
    probe_launches = probes_phase(counters)
    by_path = {**gen_launches, "train": train_launches, "lora": lora_launches,
               "cli": cli_launches,
               "mha": mha_launches, "probes": probe_launches}

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
        "flash_attention_bwd_dq": ("cuda", "svd_xtend_tpu_torch/csrc/flash_backward.cu",
                                   "svd_xtend_tpu/ops/pallas/flash_attention.py:345"),
        "flash_attention_bwd_dkv": ("cuda", "svd_xtend_tpu_torch/csrc/flash_backward.cu",
                                    "svd_xtend_tpu/ops/pallas/flash_attention.py:395"),
        "conv3x3": ("cuda", "svd_xtend_tpu_torch/csrc/conv3x3.cu",
                    "svd_xtend_tpu/ops/pallas/conv3x3.py:46"),
        "conv3x3_input_grad": ("cuda", "svd_xtend_tpu_torch/csrc/conv3x3.cu",
                               "svd_xtend_tpu/ops/pallas/conv3x3.py:46"),
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
    from svd_xtend_tpu_torch.ops.kernels import temporal_attention as ta
    from svd_xtend_tpu_torch.ops.kernels import temporal_resnet as tr
    return {
        "flash_attention_fwd": fa.flash_attention_packed,
        "frame_attention_fwd": ta.frame_attention,
        "temporal_resnet_conv_a": tr.conv_a,
        "temporal_resnet_conv_b": tr.conv_b,
        "group_norm_silu": gn.group_norm_silu,
        "group_norm_fold": gn.group_norm_fold,
        "fold_from_partials": gn.fold_from_partials,
        "geglu_fwd": gg.ln_geglu_residual,
        "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
        "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
        "conv3x3": cv.conv3x3,
        "conv3x3_input_grad": cv.conv3x3_input_grad,
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


def reset(counters):
    for fn in counters.values():
        fn.launches = 0


def read(counters, names):
    launches = {name: counters[name].launches for name in names}
    log(f"  launches in the timed run: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the path: {missing}")
    return launches


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


def fold_launches(unet_passes, encodes, decode_chunks, col):
    """The GroupNorm folds the configs imply, from the site tables: one
    group_norm_fold per GN-fold conv3x3 (every site whose epilogue starts
    with "preS") of `unet_passes` UNet passes, `encodes` VAE encodes and
    `decode_chunks` decode chunks; and per temporal resnet (column `col` of
    TRESNET_SITES: 4 per exact video, 5 per train step) one group_norm_fold
    (norm1) and one fold_from_partials (norm2, from kernel A's partials)."""
    pre = lambda sites: sum(st[5] for st in sites if st[4].startswith("preS"))
    spatial = (unet_passes * pre(UNET_CONV_SITES) + encodes * pre(VAE_ENCODE_SITES)
               + decode_chunks * pre(VAE_DECODE_SITES))
    temporal = sum(st[col] for st in TRESNET_SITES)
    return {"group_norm_fold": spatial + temporal, "fold_from_partials": temporal}


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
    """The flash forward's launches per run by (batch, tokens S), from a
    tally over `runs` runs, held against the last run's launch count, and
    their sum of launches x the kernel phase's device ms at each shape."""
    per_run = {shape: n / runs for shape, n in sorted(by_shape.items(), reverse=True)}
    if sum(per_run.values()) != launches:
        raise RuntimeError(f"{path}: {launches} forward launches, {per_run} forward calls")
    missing = [shape for shape in per_run if shape not in fwd_ms]
    if missing:
        raise RuntimeError(f"{path}: no device time for the forward at {missing}")
    ms = sum(n * fwd_ms[shape] for shape, n in per_run.items())
    log(f"  {path}: flash_attention_fwd launches per {unit} by (batch, tokens S): {per_run}")
    log(f"  [{smi}] {path}: flash forward, launches x the kernel phase's device ms: "
        f"{ms:.3f} ms per {unit}")
    return ms


def generate_phase(dev, smi, counters, ph: KernelPhase):
    """The exact generate, then the two cache modes on the same image and
    noise; {path: launches} of each mode's last timed run. The kernel
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
    launches, exact = {}, None
    for path, cfg in runs.items():
        t0 = time.time()
        generate(models, image, cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        log(f"  {path}: warm-up video {time.time() - t0:.2f} s")

        timed, new_segments = [], []
        with calls_by(fa, "flash_attention_fwd", BATCH_AND_TOKENS) as by_shape, \
                calls_by(gg, "ln_geglu_residual", GEGLU_KEY) as geglu_by_shape, \
                calls_by(tr, "conv_a", SHAPE) as conv_a_by_shape, \
                calls_by(tr, "conv_b", SHAPE) as conv_b_by_shape, \
                calls_by(ta, "frame_attention", SHAPE) as frame_by_shape, \
                calls_by(gn, "group_norm_silu", GN_KEY) as gn_by_site:
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
                                         if n not in BACKWARD_ONLY | MHA_ONLY | PROBE_ONLY])
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
        log(f"  video {tuple(video.shape)} finite, in [-1, 1], std {video.std().item():.4f}"
            f"{dist}")
        log(f"  [{smi}] {path}: seconds/video {secs:.3f} (median of {GENERATE_TIMED}); "
            f"frames/s {cfg.num_frames / secs:.3f}; peak allocated {peak / 2**30:.2f} GiB")
    return launches


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
    of their first argument (and keyword arguments); reads and writes of its attributes (the launch
    counter the function keeps on itself) go to the function."""

    def __init__(self, fn, key, tally):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_key", key)
        object.__setattr__(self, "_tally", tally)

    def __call__(self, first, *args, **kwargs):
        self._tally[self._key(first, **kwargs)] += 1
        return self._fn(first, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def calls_by(module, name, key):
    """While active, tallies the calls of `module.name` by key(first
    argument, **keyword arguments). The tally stands in for the module's global, which its
    callers (and the function itself) look up at each call."""
    tally = collections.Counter()
    original = getattr(module, name)
    setattr(module, name, _Tally(original, key, tally))
    try:
        yield tally
    finally:
        setattr(module, name, original)


BATCH_AND_TOKENS = lambda q, **_: tuple(q.shape[:2])     # a flash call's (batch, tokens S)
TOKENS = lambda q, **_: q.shape[1]                       # its tokens S
GEGLU_KEY = lambda x, **_: (x.numel() // x.shape[-1], x.shape[-1])   # GEGLU's (T, C)
SHAPE = lambda x, **_: tuple(x.shape)
GN_KEY = lambda x, silu=True, **_: (tuple(x.shape), silu)      # a GroupNorm site


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

    reset(counters)
    torch.cuda.reset_peak_memory_stats()
    metrics, secs = [], []
    # every flash_attention_bwd call launches the dQ and the dK/dV kernel once
    with calls_by(fa, "flash_attention_bwd", TOKENS) as by_len, \
            calls_by(fa, "flash_attention_fwd", BATCH_AND_TOKENS) as fwd_by_shape, \
            calls_by(gg, "ln_geglu_residual", GEGLU_KEY) as geglu_by_shape, \
            calls_by(tr, "conv_a", SHAPE) as conv_a_by_shape, \
            calls_by(ta, "frame_attention", SHAPE) as frame_by_shape, \
            calls_by(gn, "group_norm_silu", GN_KEY) as gn_by_site:
        for _ in range(TRAIN_STEPS):
            t0 = time.time()
            state, m = step(state, batch, generator=draws)
            torch.cuda.synchronize()
            secs.append(time.time() - t0)
            metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    launches = read(counters, [n for n in counters if n not in MHA_ONLY | PROBE_ONLY])
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
    per_step = {s_len: n / TRAIN_STEPS for s_len, n in sorted(by_len.items(), reverse=True)}
    want = FLASH_BWD_SITES[scope]
    log(f"  {path}: flash_attention_bwd calls per step by tokens S {per_step}; the UNet's "
        f"structure gives {want} ({sum(want.values())} a step)")
    if per_step != want:
        raise RuntimeError(f"{path}: flash backward calls per step {per_step}, the UNet's "
                           f"structure gives {want}")
    for i, name in enumerate(("flash_attention_bwd_dq", "flash_attention_bwd_dkv")):
        if sum(by_len.values()) != launches[name]:
            raise RuntimeError(f"{name}: {launches[name]} launches, {sum(by_len.values())} "
                               "backward calls")
        ms = sum(n * ph.bwd_ms[s_len][i] for s_len, n in per_step.items())
        log(f"  {path}: {name} launches per step by tokens S: {per_step}; x the kernel "
            f"phase's device ms at each S = {ms:.3f} ms per step")
    priced["flash backward pair"] = sum(n * sum(ph.bwd_ms[s_len])
                                        for s_len, n in per_step.items())
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
    """The default train step (temporal scope), then one full-scope step."""
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
    serve = read(counters, [n for n in counters if n not in BACKWARD_ONLY | MHA_ONLY | PROBE_ONLY])
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
        stats = cli.main(argv(out, *extra))
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = read(counters, [n for n in counters if n not in MHA_ONLY | PROBE_ONLY])
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
        for c in stats["checkpoints"]:
            log(f"  [{smi}] cli {name}: checkpoint-{c['step']} {c['bytes']} bytes saved in "
                f"{c['seconds']:.2f} s")
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
