// The GroupNorm fold on the card: per-(sample, channel) f32 (sc, sh) with
// GN(x) * scale + bias == x * sc + sh, for a consumer that applies the
// normalise (+ SiLU) as a prologue of its own (conv3x3.cu, the temporal
// resnet's kernels).
//
// Replaces the JAX package's group_norm_fold
// (svd_xtend_tpu/ops/pallas/groupnorm.py:274), group_norm_fold_cat (:313)
// and _fold_from_channel_sums (ops/pallas/temporal_resnet.py:240): XLA code
// there, a per-channel sum and sum of squares over the sample in one pass,
// then the fold on the (N, C) sums. Here one cooperative launch of
// gn_stats::stats_kernel (csrc/gn_stats.cuh) reads x once, 16 bytes a
// thread (bf16 pairs at the calls too small for that), into per-(sample,
// 64-row chunk) f32 partials, no copy of x, then meets at a grid barrier
// and folds them a (sample, group) at a time per block in the order of the
// fold launch it replaces, so sc and sh keep their bits (deterministic, no
// float atomics). The fold alone,
// from partials kernel A of the temporal resnet or a test wrote, is the same
// kernel with x null and no barrier before its fold.
//
// Bound by device-memory bytes (x once; the partials are a 16th of them)
// and, at the small shapes, by launch latency. Measured (chip_smoke.py and
// scripts/bench_fold.py, NVIDIA H100 80GB HBM3, 700.00 W, device time in a
// CUDA graph; PERF.md §6): the earlier design, a statistics launch (two
// channels a thread) then a fold launch (one block per (group, sample)),
// took 0.0252-0.0261 ms at the L0 temporal x (2, 14, 2560, 320), 0.0244-
// 0.0247 at (28, 40, 64, 320) and 0.1402-0.1447 at (8, 320, 512, 128), the
// fold launch alone 0.0058-0.0060 ms against its 0.0009 bound. This one
// launch, the same bits: 0.0251 ms at the L0 temporal x, 0.0269 at (28, 40,
// 64, 320), 0.137 at (8, 320, 512, 128), 0.189 at the VAE decoder's
// temporal x (1, 8, 163840, 128) against the parent's 0.235; Σ over the 1754
// folds of an exact video 39.7 ms against the two launches' 37.0
// (scripts/bench_fold.py --tree, one call): the grid barrier and the fold
// after it cost about what the second launch did; the launches and their
// host time are what went.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_stats.cuh"

// The fold of b samples of rows_per_sample rows of c channels in `groups`
// groups: where x is given (bf16 (b * rows_per_sample, c), c % 8 == 0,
// 16-byte aligned) the statistics first fill the partials psum / psq (b,
// gn_stats::slots(rows_per_sample), c) f32 from it, else they are read as
// given; sc, sh (b, c) f32 from them and scale, bias (c), f32 or, with
// affine_bf16, bf16 (read as they are: no copy a call). With x2 (the
// JAX package's group_norm_fold_cat) the c channels are the concat [x, x2]
// of x's c1 and x2's c - c1 (both multiples of 8), never built: a vector of
// 8 channels reads the part it lies in, and the fold reads the partials as
// one width, so a group that straddles the two parts is folded whole. bar:
// the stream's barrier words. One cooperative launch. Returns its CUDA error, or cudaErrorInvalidValue for a
// geometry it does not take.
extern "C" int svdx_group_norm_fold(const void* x, const void* x2, void* psum, void* psq,
                                    void* sc, void* sh, void* bar,
                                    const void* scale, const void* bias, int b,
                                    int rows_per_sample, int c, int c1, int groups,
                                    int affine_bf16, float eps, void* stream) {
  if (b < 1 || rows_per_sample < 1 || c < 8 || groups < 1 || c % groups ||
      (x2 != nullptr && x == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const gn_stats::Stats st{static_cast<float*>(psum), static_cast<float*>(psq), c,
                           rows_per_sample, gn_stats::slots(rows_per_sample)};
  const gn_stats::Fold fd = gn_stats::make_fold(bar, scale, bias, sc, sh, b,
                                                rows_per_sample, c, groups, eps, affine_bf16);
  return gn_stats::launch(x, st, fd, b * rows_per_sample, static_cast<cudaStream_t>(stream),
                          x2, c1);
}
