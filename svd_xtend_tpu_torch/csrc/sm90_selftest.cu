// A card check of the sm90.cuh building blocks the flash kernels rest on,
// one 64 x 64 x 64 product per form, and of the wide wgmma forms of
// sm90_gemm.cuh (svdx_sm90_gemm_selftest below), so that a wrong
// descriptor, swizzle or fragment layout shows as a wrong matrix, not as a
// wrong gradient somewhere in a train step. Not on any model path.
//
// One block of one warpgroup: TMA brings the 64-row tiles at rows row0..
// of sample `sample`, head `head` of two packed bf16 (batch, rows, n_cols)
// tensors a and b (rows past `rows` zero), and the warpgroup writes, in f32:
//   out[0] = A B^T         A in registers (load_a_frags), B K-major
//   out[1] = A B           A in registers, B MN-major (the transpose bit)
//   out[2] = A B^T         A and B in shared memory, both K-major
//   out[3] = bf16(A B^T) B out[0]'s accumulator re-packed in registers as
//                          A fragments (acc_to_a), B MN-major
// each a 64 x 64 row-major matrix.

#include "sm90_gemm.cuh"

namespace {

struct SelftestSmem {
  __nv_bfloat16 a[64 * 64];
  __nv_bfloat16 b[64 * 64];
  uint64_t full;
};

__device__ __forceinline__ void store_acc(float* out, const float (&d)[32], int warp,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + g + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * t + (i % 2);
    out[row * 64 + col] = d[i];
  }
}

__global__ void __launch_bounds__(128)
sm90_selftest_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map,
                     const __nv_bfloat16* __restrict__ a, float* __restrict__ out, int rows,
                     int n_cols, int sample, int row0, int head) {
  extern __shared__ char smem_raw[];
  SelftestSmem& sm = sm90::aligned_smem<SelftestSmem>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(&sm.full, 2 * 64 * 64 * 2);
    sm90::tma_load_3d(sm.a, &a_map, &sm.full, head * 64, row0, sample);
    sm90::tma_load_3d(sm.b, &b_map, &sm.full, head * 64, row0, sample);
  }
  uint32_t af[4][4];
  sm90::load_a_frags(af, a + (size_t)sample * rows * n_cols + head * 64, row0, rows, n_cols,
                     warp, lane);
  sm90::mbar_wait(&sm.full, 0);
  const uint64_t ad = sm90::sw128_desc(sm.a), bd = sm90::sw128_desc(sm.b);

  float d0[32], d1[32], d2[32], d3[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d0[i] = d1[i] = d2[i] = d3[i] = 0.f;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    sm90::wgmma_rs<0>(d0, af[kk], sm90::kmajor_slice(bd, kk), kk > 0);
    sm90::wgmma_rs<1>(d1, af[kk], sm90::mnmajor_slice(bd, kk), kk > 0);
    sm90::wgmma_ss<0, 0>(d2, sm90::kmajor_slice(ad, kk), sm90::kmajor_slice(bd, kk), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(d0);
  sm90::fence_regs(d1);
  sm90::fence_regs(d2);

  uint32_t pf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::acc_to_a(pf[kk], d0, kk);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs<1>(d3, pf[kk], sm90::mnmajor_slice(bd, kk), kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(d3);

  store_acc(out, d0, warp, lane);
  store_acc(out + 4096, d1, warp, lane);
  store_acc(out + 2 * 4096, d2, warp, lane);
  store_acc(out + 3 * 4096, d3, warp, lane);
}

// the wide forms: out (64 x kN f32) = A (64 x 64) . B (kN x 64)^T with
// wgmma_ss_n<kN>, both tiles by TMA (2-D maps, sm90_gemm::encode_matrix_map)
template <int kN>
struct GemmFormSmem {
  __nv_bfloat16 a[64 * 64];
  __nv_bfloat16 b[kN * 64];
  uint64_t full;
};

template <int kN>
__global__ void __launch_bounds__(128)
gemm_form_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map, float* __restrict__ out) {
  extern __shared__ char smem_raw[];
  GemmFormSmem<kN>& sm = sm90::aligned_smem<GemmFormSmem<kN>>(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(&sm.full, (64 + kN) * 64 * 2);
    sm90::tma_load_3d(sm.a, &a_map, &sm.full, 0, 0, 0);
    sm90::tma_load_3d(sm.b, &b_map, &sm.full, 0, 0, 0);
  }
  sm90::mbar_wait(&sm.full, 0);
  const uint64_t ad = sm90::sw128_desc(sm.a), bd = sm90::sw128_desc(sm.b);
  float d[kN / 2];
  sm90::wgmma_fence();
  sm90::fence_regs(d);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90_gemm::wgmma_ss_n<kN>(d, sm90::kmajor_slice(ad, kk), sm90::kmajor_slice(bd, kk), kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(d);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kN / 2; ++i)
    out[(16 * warp + g + 8 * ((i / 2) % 2)) * kN + 8 * (i / 4) + 2 * t + (i % 2)] = d[i];
}

template <int kN>
int launch_gemm_form(const void* a, const void* b, void* out, cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  int err = sm90_gemm::encode_matrix_map(&a_map, a, 64, 64, 64);
  if (err == 0) err = sm90_gemm::encode_matrix_map(&b_map, b, 64, kN, kN);
  if (err != 0) return err;
  constexpr int smem = sm90::smem_bytes<GemmFormSmem<kN>>();
  err = static_cast<int>(cudaFuncSetAttribute(
      gemm_form_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  gemm_form_kernel<kN><<<1, 128, smem, stream>>>(a_map, b_map, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b: bf16 (batch, rows, n_cols) contiguous; out: f32 (4, 64, 64). Returns
// the tensor-map encoder's refusal without launching (a or b not 16-byte
// aligned, n_cols * 2 not a multiple of 16), or cudaGetLastError().
extern "C" int svdx_sm90_selftest(const void* a, const void* b, void* out, int batch, int rows,
                                  int n_cols, int sample, int row0, int head, void* stream) {
  CUtensorMap a_map, b_map;
  int err = sm90::encode_rows_map(&a_map, a, n_cols, rows, batch, 64);
  if (err == 0) err = sm90::encode_rows_map(&b_map, b, n_cols, rows, batch, 64);
  if (err != 0) return err;
  constexpr int smem = sm90::smem_bytes<SelftestSmem>();
  err = static_cast<int>(cudaFuncSetAttribute(
      sm90_selftest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  sm90_selftest_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      a_map, b_map, static_cast<const __nv_bfloat16*>(a), static_cast<float*>(out), rows,
      n_cols, sample, row0, head);
  return static_cast<int>(cudaGetLastError());
}

// a: bf16 (64, 64), b: bf16 (n, 64), out: f32 (64, n), all contiguous; n one
// of the wgmma widths sm90_gemm.cuh has (8, 128, 160, 256). out = a b^T
// through one wgmma_ss_n<n> per k16 slice. Returns cudaErrorInvalidValue for
// another n, else the encoder's refusal or cudaGetLastError().
extern "C" int svdx_sm90_gemm_selftest(const void* a, const void* b, void* out, int n,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return launch_gemm_form<8>(a, b, out, s);
    case 128: return launch_gemm_form<128>(a, b, out, s);
    case 160: return launch_gemm_form<160>(a, b, out, s);
    case 256: return launch_gemm_form<256>(a, b, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
