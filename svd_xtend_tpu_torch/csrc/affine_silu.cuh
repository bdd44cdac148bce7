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
// conv's loads. The arithmetic rounds where the plain versions do (x * sc,
// then + sh, no fused multiply-add; sigmoid = 1 / (1 + exp(-v)), then the
// product): kernel A's output at the L0 temporal site came within rel-L2
// 4.1e-5 of its plain version, against 5.2e-5 with a fused multiply-add and
// one division (H100 80GB HBM3, 700 W, chip_smoke.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace affine_silu {

constexpr int kThreads = 256;

template <bool kSilu>
__global__ void __launch_bounds__(kThreads)
kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ sc,
       const float* __restrict__ sh, __nv_bfloat16* __restrict__ u, long long chunks, int c,
       int rows_per_sample) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= chunks) return;
  const long long e0 = i * 8;  // first element of the chunk
  const long long m = e0 / c;
  const size_t pc = (size_t)(m / rows_per_sample) * c + (e0 - m * c);
  const uint4 raw = *reinterpret_cast<const uint4*>(x + e0);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float4* sc4 = reinterpret_cast<const float4*>(sc + pc);
  const float4* sh4 = reinterpret_cast<const float4*>(sh + pc);
  const float4 s_lo = __ldg(sc4), s_hi = __ldg(sc4 + 1);
  const float4 h_lo = __ldg(sh4), h_hi = __ldg(sh4 + 1);
  const float sv[8] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w, s_hi.x, s_hi.y, s_hi.z, s_hi.w};
  const float hv[8] = {h_lo.x, h_lo.y, h_lo.z, h_lo.w, h_hi.x, h_hi.y, h_hi.z, h_hi.w};
  uint32_t o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 xv = __bfloat1622float2(e[q]);
    float v[2] = {xv.x, xv.y};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      v[j] = __fadd_rn(__fmul_rn(v[j], sv[2 * q + j]), hv[2 * q + j]);
      if (kSilu) v[j] = __fmul_rn(v[j], __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v[j]))));
    }
    const float v0 = v[0], v1 = v[1];
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
    o[q] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(u + e0) = make_uint4(o[0], o[1], o[2], o[3]);
}

// u over m rows of c channels (c % 8 == 0, every pointer 16-byte aligned);
// returns cudaGetLastError() after the launch
static inline int launch(const void* x, const void* sc, const void* sh, void* u, long long m,
                         int c, int rows_per_sample, bool silu, cudaStream_t s) {
  const long long chunks = m * c / 8;
  const int blocks = static_cast<int>((chunks + kThreads - 1) / kThreads);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* scp = static_cast<const float*>(sc);
  const auto* shp = static_cast<const float*>(sh);
  auto* up = static_cast<__nv_bfloat16*>(u);
  if (silu)
    kernel<true><<<blocks, kThreads, 0, s>>>(xp, scp, shp, up, chunks, c, rows_per_sample);
  else
    kernel<false><<<blocks, kThreads, 0, s>>>(xp, scp, shp, up, chunks, c, rows_per_sample);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace affine_silu
}  // namespace
