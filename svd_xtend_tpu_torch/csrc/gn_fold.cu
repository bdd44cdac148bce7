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
//   - fold_kernel, one block per (group, sample): the group's partials (its
//     channels of every slot) summed in a fixed order, then mean, the
//     variance clamped at 0 (E[x^2] - mean^2, as the JAX formula), 1 /
//     sqrt(var + eps), and sc, sh for the group's channels.
// Both are bound by device-memory bytes (x once; the partials are a 64th of
// it) and by launch latency at the small shapes. Deterministic: no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_stats.cuh"

namespace {

constexpr int kFoldThreads = 256;

__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const float* __restrict__ psum, const float* __restrict__ psq,
            const float* __restrict__ scale, const float* __restrict__ bias,
            float* __restrict__ sc, float* __restrict__ sh, int slots, int c, int gs,
            float denom, float eps) {
  const int g = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const size_t base = (size_t)b * slots * c + (size_t)g * gs;
  float s = 0.f, s2 = 0.f;
  for (int i = t; i < slots * gs; i += kFoldThreads) {
    const int slot = i / gs, j = i - slot * gs;
    const size_t o = base + (size_t)slot * c + j;
    s += psum[o];
    s2 += psq[o];
  }
  __shared__ float red[2][kFoldThreads];
  red[0][t] = s;
  red[1][t] = s2;
  __syncthreads();
  for (int h = kFoldThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
      red[0][t] += red[0][t + h];
      red[1][t] += red[1][t + h];
    }
    __syncthreads();
  }
  const float mean = red[0][0] / denom;
  const float var = fmaxf(red[1][0] / denom - mean * mean, 0.f);
  const float inv = rsqrtf(var + eps);
  for (int j = t; j < gs; j += kFoldThreads) {
    const int ch = g * gs + j;
    const float a = inv * scale[ch];
    sc[(size_t)b * c + ch] = a;
    sh[(size_t)b * c + ch] = bias[ch] - mean * a;
  }
}

}  // namespace

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
  const int slots = gn_stats::slots(rows_per_sample);
  auto* ps = static_cast<float*>(psum);
  auto* pq = static_cast<float*>(psq);
  if (x != nullptr) {
    const gn_stats::Stats st{ps, pq, c, rows_per_sample, slots};
    const int err = gn_stats::launch(x, st, b * rows_per_sample, s);
    if (err) return err;
  }
  const int gs = c / groups;
  fold_kernel<<<dim3(groups, b), kFoldThreads, 0, s>>>(
      ps, pq, static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(sc), static_cast<float*>(sh), slots, c, gs,
      static_cast<float>((double)rows_per_sample * gs), eps);
  return static_cast<int>(cudaGetLastError());
}
