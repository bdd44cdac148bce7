// Residual GEGLU feed-forward on (T, C) tokens:
//
//   y = x + (h * gelu_tanh(g)) W2^T + b2,   [h | g] = LN(x) W1^T + b1
//
// Replaces svd_xtend_tpu/ops/pallas/geglu.py::_kernel (the norm3/ff and
// norm_in/ff_in feed-forwards of every spatial and temporal transformer
// block). Numerics as the TPU kernel: LayerNorm (eps 1e-5) statistics in
// f32, its output rounded to bf16; both products on bf16 operands with f32
// accumulation; the gate product u rounded to bf16 before the second
// product; tanh GELU; the residual added in bf16.
//
// Three launches, the LayerNorm'd tokens and u through device memory:
//   ln:    one warp per token row, two-pass f32 statistics -> xn (T, C) bf16;
//   gemm1: xn @ W1^T with the value/gate pairing in the epilogue: a block's
//          128 B-tile rows interleave 8 value rows and the matching 8 gate
//          rows of W1, so each thread holds h and g of the same column and
//          writes u = (h + b1) * gelu(g + b1) (T, 4C) bf16;
//   gemm2: u @ W2^T, epilogue + b2 and the bf16 residual x.
// Why through device memory, against the TPU kernel's design: keeping u on
// chip needs the (rows, C) f32 output accumulator of a token tile on chip
// for the whole inner loop; at C = 1280 a 64-row tile is 320 KB, so the
// first version of this kernel (one fused launch, accumulator in registers
// over 8 warps) took 32-row tiles and re-read every weight from L2 per tile:
// 0.877 ms at the L0 training site against 0.576 ms for the unfused bf16
// cuBLAS path, 3.27 ms per call at C >= 640 in a train step, and generate
// 6.95 s/video against 2.96 (H100 80GB HBM3, 700 W). Through memory, u
// costs 2*T*4C*2 bytes (184 MB at L0 training, ~55 us at 3.35 TB/s), and
// both products become GEMMs with 128-row tiles that read each weight once
// per 128 tokens.
//
// GEMM design (both): 128 x BN x 32 block tiles, 8 warps, a 3-stage cp.async
// ring in shared memory (rows past T are zero-filled), fragments by
// ldmatrix, mma.sync m16n8k16 bf16 -> f32. Both operands are K-contiguous:
// activations (T, K) row-major and nn.Linear weights (N, K) row-major.
//
// Not yet done (later work): wgmma/TMA, a persistent tile scheduler, fusing
// the LayerNorm into gemm1's loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kLds = kBK + 8;  // 80-byte rows: conflict-free ldmatrix
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16-byte async copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float gelu_tanh(float g) {
  const float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
  return 0.5f * g * (1.f + tanhf(inner));
}

// ---------------------------------------------------------------- LayerNorm
__global__ void __launch_bounds__(kThreads)
ln_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ ls,
          const float* __restrict__ lb, __nv_bfloat16* __restrict__ xn, int n_tok, int c) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_tok) return;
  const __nv_bfloat16* xr = x + (size_t)row * c;
  float sum = 0.f;
  for (int i = 2 * lane; i < c; i += 64) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + i));
    sum += v.x + v.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mu = sum / c;
  float sq = 0.f;
  for (int i = 2 * lane; i < c; i += 64) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + i));
    sq += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / c + kLnEps);
  for (int i = 2 * lane; i < c; i += 64) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + i));
    *reinterpret_cast<uint32_t*>(xn + (size_t)row * c + i) =
        pack_bf16((v.x - mu) * rstd * ls[i] + lb[i], (v.y - mu) * rstd * ls[i + 1] + lb[i + 1]);
  }
}

// --------------------------------------------------------------------- GEMM
// acc[MI][4][4] of a 128 x BN tile of A (M, K) @ B^T; B rows of the tile are
// given by b_row(r) (r in [0, BN)), A rows past m are zero.
template <int BN>
struct Tile {
  static constexpr int kWarpsN = BN / 32;           // warp tile: (128 / kWarpsM) x 32
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kMI = 128 / kWarpsM / 16;
  static constexpr int kStageElems = (kBM + BN) * kLds;
};

template <int BN, typename BRow>
__device__ __forceinline__ void gemm_mainloop(float (&acc)[Tile<BN>::kMI][4][4],
                                              __nv_bfloat16* smem,
                                              const __nv_bfloat16* __restrict__ a, int m0,
                                              int m, const __nv_bfloat16* __restrict__ b,
                                              BRow b_row, int k) {
  using T = Tile<BN>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
#pragma unroll
  for (int i = 0; i < T::kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int stage, int k0) {
    __nv_bfloat16* as = smem + stage * T::kStageElems;
    __nv_bfloat16* bs = as + kBM * kLds;
#pragma unroll
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i >> 2, ch = (i & 3) * 8;
      const bool ok = m0 + r < m;
      cp_async16(as + r * kLds + ch, a + (size_t)(ok ? m0 + r : 0) * k + k0 + ch, ok);
    }
#pragma unroll
    for (int i = tid; i < BN * (kBK / 8); i += kThreads) {
      const int r = i >> 2, ch = (i & 3) * 8;
      cp_async16(bs + r * kLds + ch, b + (size_t)b_row(r) * k + k0 + ch, true);
    }
  };

  const int kt_n = k / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) load(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < kt_n) load(next % kStages, next * kBK);
    cp_async_commit();

    const __nv_bfloat16* as = smem + (kt % kStages) * T::kStageElems;
    const __nv_bfloat16* bs = as + kBM * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[T::kMI][4];
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
        ldmatrix_x4(af[mi], as + (wm * T::kMI * 16 + mi * 16 + (lane & 15)) * kLds + kk +
                                (lane >> 4) * 8);
      uint32_t bf[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4(bf[nj], bs + (wn * 32 + nj * 16 + (lane >> 4) * 8 + (lane & 7)) * kLds +
                                kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
}

// xn (T, C) @ W1^T -> u (T, inner): the block's 64 u columns j0.. read W1
// rows interleaved in groups of 8: tile rows 16p..16p+7 are value rows
// j0+8p.., tile rows 16p+8..16p+15 the matching gate rows inner+j0+8p..
__global__ void __launch_bounds__(kThreads)
gemm1_kernel(const __nv_bfloat16* __restrict__ xn, const __nv_bfloat16* __restrict__ w1,
             const float* __restrict__ b1, __nv_bfloat16* __restrict__ u, int n_tok, int c) {
  constexpr int BN = 128;
  using T = Tile<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int inner = 4 * c;
  const int m0 = blockIdx.x * kBM, j0 = blockIdx.y * 64;
  auto b_row = [&](int r) {
    const int p = r >> 4, w = r & 15;
    return w < 8 ? j0 + 8 * p + w : inner + j0 + 8 * p + (w - 8);
  };
  float acc[T::kMI][4][4];
  gemm_mainloop<BN>(acc, smem, xn, m0, n_tok, w1, b_row, c);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    // n-tiles 2q (value) and 2q+1 (gate) of this warp cover u columns col, col+1
    const int col = j0 + (wn * 2 + q) * 8 + 2 * t;
    const float bh0 = b1[col], bh1 = b1[col + 1];
    const float bg0 = b1[inner + col], bg1 = b1[inner + col + 1];
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int row = m0 + wm * T::kMI * 16 + mi * 16 + g + 8 * hlf;
        if (row >= n_tok) continue;
        const float* hv = acc[mi][2 * q];
        const float* gv = acc[mi][2 * q + 1];
        *reinterpret_cast<uint32_t*>(u + (size_t)row * inner + col) =
            pack_bf16((hv[2 * hlf] + bh0) * gelu_tanh(gv[2 * hlf] + bg0),
                      (hv[2 * hlf + 1] + bh1) * gelu_tanh(gv[2 * hlf + 1] + bg1));
      }
  }
}

// u (T, inner) @ W2^T + b2 + x -> out (T, C).
template <int BN>
__global__ void __launch_bounds__(kThreads)
gemm2_kernel(const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ w2,
             const float* __restrict__ b2, const __nv_bfloat16* __restrict__ x,
             __nv_bfloat16* __restrict__ out, int n_tok, int c) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  float acc[T::kMI][4][4];
  gemm_mainloop<BN>(acc, smem, u, m0, n_tok, w2, [&](int r) { return n0 + r; }, 4 * c);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t;
    const float c0 = b2[col], c1 = b2[col + 1];
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int row = m0 + wm * T::kMI * 16 + mi * 16 + g + 8 * hlf;
        if (row >= n_tok) continue;
        const size_t off = (size_t)row * c + col;
        const float2 y = __bfloat1622float2(__floats2bfloat162_rn(
            acc[mi][ni][2 * hlf] + c0, acc[mi][ni][2 * hlf + 1] + c1));
        const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + off));
        *reinterpret_cast<uint32_t*>(out + off) = pack_bf16(xf.x + y.x, xf.y + y.y);
      }
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// x, out: (n_tok, c) bf16; xn: (n_tok, c) bf16 and u: (n_tok, 4c) bf16
// scratch; w1: (8c, c) bf16; w2: (c, 4c) bf16; ls, lb, b2: (c,) f32; b1:
// (8c,) f32; all contiguous, c % 64 == 0 (the wrapper checks). Returns the
// first CUDA error of the three launches (0 on success).
extern "C" int svdx_ln_geglu_residual(const void* x, const void* ls, const void* lb,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, void* xn, void* u, void* out, int n_tok,
                                      int c, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  auto* xnp = static_cast<__nv_bfloat16*>(xn);
  auto* up = static_cast<__nv_bfloat16*>(u);
  const int m_tiles = (n_tok + kBM - 1) / kBM;

  ln_kernel<<<(n_tok + 7) / 8, kThreads, 0, s>>>(xp, static_cast<const float*>(ls),
                                                static_cast<const float*>(lb), xnp, n_tok, c);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const int smem1 = kStages * Tile<128>::kStageElems * 2;
  if ((err = set_smem(gemm1_kernel, smem1))) return err;
  gemm1_kernel<<<dim3(m_tiles, (4 * c) / 64), kThreads, smem1, s>>>(
      xnp, static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1), up, n_tok, c);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;

  const auto* w2p = static_cast<const __nv_bfloat16*>(w2);
  const auto* b2p = static_cast<const float*>(b2);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (c % 128 == 0) {
    const int smem2 = kStages * Tile<128>::kStageElems * 2;
    if ((err = set_smem(gemm2_kernel<128>, smem2))) return err;
    gemm2_kernel<128><<<dim3(m_tiles, c / 128), kThreads, smem2, s>>>(up, w2p, b2p, xp, op,
                                                                      n_tok, c);
  } else {
    const int smem2 = kStages * Tile<64>::kStageElems * 2;
    if ((err = set_smem(gemm2_kernel<64>, smem2))) return err;
    gemm2_kernel<64><<<dim3(m_tiles, c / 64), kThreads, smem2, s>>>(up, w2p, b2p, xp, op,
                                                                    n_tok, c);
  }
  return static_cast<int>(cudaGetLastError());
}
