// The GroupNorm fold on the card: per-(sample, channel) f32 (sc, sh) with
// GN(x) * scale + bias == x * sc + sh, for a consumer that applies the
// normalise (+ SiLU) as a prologue of its own (conv3x3.cu, the temporal
// resnet's kernels).
//
// Replaces the JAX package's group_norm_fold
// (svd_xtend_tpu/ops/pallas/groupnorm.py:274) and _fold_from_channel_sums
// (ops/pallas/temporal_resnet.py:240): XLA code there, a per-channel sum and
// sum of squares over the sample in one pass, then the fold on the (N, C)
// sums. In plain torch the first made two f32 copies of x and the second
// took about ten small launches; here:
//   - stats_kernel (csrc/gn_stats.cuh) reads x once into per-(sample, 64-row
//     chunk) partials, f32 sums, no copy of x; the fold alone starts from
//     partials kernel A of the temporal resnet wrote;
//   - gn_stats::fold_kernel, one block per (group, sample): the group's
//     partials summed in a fixed order, then mean, the clamped variance and
//     sc, sh for the group's channels (csrc/gn_stats.cuh).
// Both are bound by device-memory bytes (x once; the partials are a 64th of
// it) and by launch latency at the small shapes. Deterministic: no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_stats.cuh"

// The fold of b samples of rows_per_sample rows of c channels in `groups`
// groups: where x is given (bf16 (b * rows_per_sample, c), c even, 4-byte
// aligned) stats_kernel first fills the partials psum / psq (b,
// gn_stats::slots(rows_per_sample), c) f32 from it, else they are read as
// given; then sc, sh (b, c) f32 from them and scale, bias (c) f32. Returns
// the first CUDA error of the launches, or cudaErrorInvalidValue for a
// geometry it does not take.
extern "C" int svdx_group_norm_fold(const void* x, void* psum, void* psq, const void* scale,
                                    const void* bias, void* sc, void* sh, int b,
                                    int rows_per_sample, int c, int groups, float eps,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || rows_per_sample < 1 || c < 2 || c % 2 || groups < 1 || c % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const gn_stats::Stats st{static_cast<float*>(psum), static_cast<float*>(psq), c,
                           rows_per_sample, gn_stats::slots(rows_per_sample)};
  if (x != nullptr) {
    const int err = gn_stats::launch(x, st, b * rows_per_sample, s);
    if (err) return err;
  }
  return gn_stats::fold(st, b, groups, scale, bias, sc, sh, eps, s);
}
