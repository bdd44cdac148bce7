// The elementwise prologue of the implicit-GEMM convolutions (csrc/conv3x3.cu,
// csrc/temporal_resnet.cu): the folded GroupNorm normalise (+ SiLU) of the
// conv's input as a pass of its own,
//
//   u = bf16([silu](x*sc + sh)),   sc, sh per (sample, channel) f32,
//
// over m rows of c bf16 channels, a sample being `rows_per_sample`
// consecutive rows. The conv then reads u through TMA, whose out-of-bounds
// fill keeps the padding zero after the transform, as the TPU kernels pad
// after it. 8 channels (16 bytes) a thread: bound by device-memory bytes,
// 2 * |x| once. conv3x3.cu says why this is a pass and not part of the
// conv's loads. The same pass in fp16 and f32 (16 bytes a thread, u of x's
// type) is the second pass of group_norm_silu's two-pass path
// (csrc/group_norm.cu). The arithmetic rounds where the plain versions do
// (x * sc, then + sh, no fused multiply-add; sigmoid = 1 / (1 + exp(-v)),
// then the product): kernel A's output at the L0 temporal site came within rel-L2
// 4.1e-5 of its plain version, against 5.2e-5 with a fused multiply-add and
// one division (H100 80GB HBM3, 700 W, chip_smoke.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace affine_silu {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// 16 bytes of x (kVec elements) a thread
template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreads)
kernel(const T* __restrict__ x, const float* __restrict__ sc, const float* __restrict__ sh,
       T* __restrict__ u, long long chunks, int c, int rows_per_sample) {
  constexpr int kVec = 16 / sizeof(T);
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= chunks) return;
  const long long e0 = i * kVec;  // first element of the chunk
  const long long m = e0 / c;
  const size_t pc = (size_t)(m / rows_per_sample) * c + (e0 - m * c);
  const uint4 raw = *reinterpret_cast<const uint4*>(x + e0);
  const T* e = reinterpret_cast<const T*>(&raw);
  __align__(16) T o[kVec];
#pragma unroll
  for (int q = 0; q < kVec / 4; ++q) {
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(sc + pc) + q);
    const float4 h4 = __ldg(reinterpret_cast<const float4*>(sh + pc) + q);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
    const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = to_f32(e[4 * q + j]);
      v = __fadd_rn(__fmul_rn(v, sv[j]), hv[j]);
      if (kSilu) v = __fmul_rn(v, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v))));
      o[4 * q + j] = from_f32<T>(v);
    }
  }
  *reinterpret_cast<uint4*>(u + e0) = *reinterpret_cast<const uint4*>(o);
}

// u over m rows of c channels of type T (16 bytes of channels a whole
// number, every pointer 16-byte aligned); returns cudaGetLastError() after
// the launch
template <typename T = __nv_bfloat16>
static inline int launch(const void* x, const void* sc, const void* sh, void* u, long long m,
                         int c, int rows_per_sample, bool silu, cudaStream_t s) {
  const long long chunks = m * c / (16 / sizeof(T));
  const int blocks = static_cast<int>((chunks + kThreads - 1) / kThreads);
  const auto* xp = static_cast<const T*>(x);
  const auto* scp = static_cast<const float*>(sc);
  const auto* shp = static_cast<const float*>(sh);
  auto* up = static_cast<T*>(u);
  if (silu)
    kernel<T, true><<<blocks, kThreads, 0, s>>>(xp, scp, shp, up, chunks, c, rows_per_sample);
  else
    kernel<T, false><<<blocks, kThreads, 0, s>>>(xp, scp, shp, up, chunks, c, rows_per_sample);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace affine_silu
}  // namespace
