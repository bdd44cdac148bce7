// int8 x int8 -> int32 GEMM with the W8A8 dequantising epilogue, the second
// half of the opt-in int8 path (PipelineConfig.unet_quant / vae_quant):
//
//   acc[r, co] = sum_k a[r, k] * b[co, k]                       (exact, int32)
//   s[co] = wamax[co] * (max(xamax, 1e-12) * f32(1/127)^2)     (= sx * sw[co])
//   y = bf16(f32(acc) * s[co] + bias[co])
//   y = bf16(y + bf16(post[sample(r), co]))   y = bf16(y + res[r, co])
//
// Replaces the JAX package's svd_xtend_tpu/ops/quant.py::int8_conv3x3 (:258)
// and ::int8_dense (:240) after their quantize_dynamic, which XLA computes
// (no Pallas kernel). The epilogue keeps JAX's order (quant.py:252-255,
// 271-278): the scale product first, then the bias in f32, one cast to the
// activation type, then the shift and the residual each added in that
// type. The scale product is taken in the form XLA compiles it to under jit
// (its simplifier gathers the two f32(1/127) constants into their square;
// ops/quant.py::dequant_scale), from the activation's amax and the
// weights' clamped amaxes. Every step is an explicit round-to-nearest
// operation (__fmul_rn, __fadd_rn: nvcc contracts none of them into a fused
// multiply-add), and the
// int32 accumulator is exact, so the output is the plain version's bit for
// bit (ops/kernels/int8_gemm.py).
//
// Two A loaders: dense rows a (M, K), or the 3x3 SAME implicit GEMM over
// NHWC int8 codes (M = N*H*W pixels, K = 9*Ci, k = tap*Ci + ci, tap = 3 dy +
// dx, the padding read as zeros). B is the weight codes, K-major: (Co, K),
// which for the conv is the OIHW weight's (Co, 3, 3, Ci) permute.
//
// What bounds it on an H100: at the UNet's L0 CFG site (28 x 40 x 64,
// 320 -> 320) 1.32e11 operations, 0.067 ms at the 1,979 TOP/s int8 rate,
// against 0.035 ms of bytes (int8 in, bf16 out): tensor-core bound at the
// convs, as the bf16 conv3x3 kernel is. The dense sites with wide outputs
// (the feed-forward's 2*4C projection) write 2 bytes an output against
// 2*K operations, and are closer to their bytes.
//
// Design, kept simple in this first version: the mma.sync mainloop of the
// bf16 conv3x3 kernel's first version (csrc/conv3x3.cu, conv3x3_kernel) in
// int8: mma.sync m16n8k32 .s32.s8.s8 fed by ldmatrix from a 4-stage cp.async
// ring of 64-byte K tiles (two k32 steps), 128 x BN block tiles, the
// loaders computing each chunk's source (its tap, its shifted pixel, the
// padding as a zero fill). 16-byte chunks where Ci (conv) or K (dense) is a
// multiple of 16; 4-byte chunks otherwise (the UNet's conv_in, Ci 8, K 72;
// the VAE decoder's conv_in, Ci 4). BN is 128 (8 warps of 64 x 32), or 32
// for the thin outputs (4 warps of 32 x 32: the UNet's conv_out, Co 4, and
// the decoder's, Co 3), where a 128-wide tile would compute 32-42 times the
// columns it keeps. The shared Hopper mainloop of csrc/sm90_gemm.cuh (TMA
// im2col + wgmma) was not made generic over the operand type here: that
// would touch every bf16 kernel built on it, and this path is opt-in; the
// wgmma m64nNk32 .s8 form is the redesign to try when these times call for
// it (the chip_smoke int8 phase prints each site's time beside the bf16
// kernel's and its bound).
//
// The raw form (dense only, stats null): the exact int32 sums acc written as
// they are, with no epilogue. A row-parallel product under tensor
// parallelism (parallel/tensor.py) sums its ranks' int32 partials exactly
// over the model group and dequantises the sum once, so the output is the
// one-rank product's bit for bit (ops/kernels/int8_gemm.py::dense_sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace int8_gemm {

constexpr int kBM = 128;
constexpr int kBK = 64;          // int8 values (bytes) of K per tile: two k32 steps
constexpr int kStages = 4;
constexpr int kLds = kBK + 16;   // 80-byte rows: conflict-free ldmatrix

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// kBytes-byte async copy global -> shared; zero-fills when !valid
template <int kBytes>
__device__ __forceinline__ void cp_async(int8_t* dst, const int8_t* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// A 128 x BN block tile in kWarpsM x kWarpsN warps of kWM x kWN; a thread
// loads one kChunk-byte chunk of rows r, r + kRowStep, ... of each tile.
template <int BN, int kWarpsM, int kWarpsN, int kChunk>
struct Tile {
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kWM = kBM / kWarpsM;
  static constexpr int kWN = BN / kWarpsN;
  static constexpr int kMI = kWM / 16;
  static constexpr int kNI = kWN / 8;
  static constexpr int kChunks = kBK / kChunk;
  static constexpr int kRowStep = kThreads / kChunks;
  static constexpr int kARows = kBM / kRowStep;
  static constexpr int kBRows = (BN + kRowStep - 1) / kRowStep;
  static constexpr int kStageBytes = (kBM + BN) * kLds;
  static constexpr int kSmemBytes = kStages * kStageBytes;
  static_assert(kNI % 2 == 0, "B fragments come two n8 blocks a ldmatrix");
};

struct Params {
  const int8_t* a;           // dense (m, kdim); conv (N, H, W, ci) codes
  const int8_t* b;           // (co, kdim)
  const float* stats;        // (amax, scale) of a, on the device
  const float* wamax;        // (co) the weights' clamped amaxes
  const float* bias;         // (co) f32 or null
  const float* post;         // (m / hw, co) f32 or null
  const __nv_bfloat16* res;  // (m, co) or null
  __nv_bfloat16* out;        // (m, co)
  int32_t* sums;             // (m, co): the raw form's output
  int m, co, kdim;
  int h, wd, ci, hw;         // the conv's geometry (unused for dense)
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int BN, int kWarpsM, int kWarpsN, int kChunk, bool kConv, bool kRaw>
__global__ void __launch_bounds__(32 * kWarpsM * kWarpsN)
gemm_kernel(const Params p) {
  using T = Tile<BN, kWarpsM, kWarpsN, kChunk>;
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;

  // this thread's A rows and chunk column
  const int r0 = tid / T::kChunks, ch = (tid % T::kChunks) * kChunk;
  int a_m[T::kARows], a_y[T::kARows], a_x[T::kARows];
  bool a_ok[T::kARows];
#pragma unroll
  for (int j = 0; j < T::kARows; ++j) {
    const int m = m0 + r0 + T::kRowStep * j;
    a_ok[j] = m < p.m;
    a_m[j] = m;
    a_y[j] = a_x[j] = 0;
    if (kConv) {
      const int rem = m - (m / p.hw) * p.hw;
      a_y[j] = rem / p.wd;
      a_x[j] = rem - a_y[j] * p.wd;
    }
  }

  int acc[T::kMI][T::kNI][4];
#pragma unroll
  for (int i = 0; i < T::kMI; ++i)
#pragma unroll
    for (int j = 0; j < T::kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto load = [&](int stage, int kt) {
    int8_t* as = smem + stage * T::kStageBytes;
    int8_t* bs = as + kBM * kLds;
    const int k = kt * kBK + ch;
    const bool k_ok = k < p.kdim;
    if (kConv) {
      // a chunk lies in one tap (ci is a multiple of kChunk)
      const int tap = k_ok ? k / p.ci : 0;
      const int c = k - tap * p.ci;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int j = 0; j < T::kARows; ++j) {
        const int ys = a_y[j] + dy, xs = a_x[j] + dx;
        const bool ok = k_ok && a_ok[j] && ys >= 0 && ys < p.h && xs >= 0 && xs < p.wd;
        const int8_t* src = p.a + (ok ? (size_t)(a_m[j] + dy * p.wd + dx) * p.ci + c : 0);
        cp_async<kChunk>(as + (r0 + T::kRowStep * j) * kLds + ch, src, ok);
      }
    } else {
#pragma unroll
      for (int j = 0; j < T::kARows; ++j) {
        const bool ok = k_ok && a_ok[j];
        cp_async<kChunk>(as + (r0 + T::kRowStep * j) * kLds + ch,
                         p.a + (ok ? (size_t)a_m[j] * p.kdim + k : 0), ok);
      }
    }
#pragma unroll
    for (int i = 0; i < T::kBRows; ++i) {
      const int r = r0 + T::kRowStep * i;
      if (r >= BN) break;
      const int co = n0 + r;
      const bool ok = k_ok && co < p.co;
      cp_async<kChunk>(bs + r * kLds + ch, p.b + (ok ? (size_t)co * p.kdim + k : 0), ok);
    }
  };

  const int kt_n = (p.kdim + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < kt_n) load(next % kStages, next);
    cp_async_commit();

    const int8_t* as = smem + (kt % kStages) * T::kStageBytes;
    const int8_t* bs = as + kBM * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[T::kMI][4];
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
        ldmatrix_x4(af[mi], as + (wm * T::kWM + mi * 16 + (lane & 15)) * kLds + kk +
                                (lane >> 4) * 16);
      uint32_t bf[T::kNI / 2][4];
#pragma unroll
      for (int nj = 0; nj < T::kNI / 2; ++nj)
        ldmatrix_x4(bf[nj], bs + (wn * T::kWN + nj * 16 + (lane >> 4) * 8 + (lane & 7)) * kLds +
                                kk + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::kNI; ++ni)
          mma_s8(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
  if constexpr (kRaw) {
#pragma unroll
    for (int ni = 0; ni < T::kNI; ++ni) {
      const int col = n0 + wn * T::kWN + ni * 8 + 2 * t;
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const int row = m0 + wm * T::kWM + mi * 16 + g + 8 * hlf;
          if (row >= p.m) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col + e < p.co) p.sums[(size_t)row * p.co + col + e] = acc[mi][ni][2 * hlf + e];
        }
    }
    return;
  }
  // epilogue, in JAX's order: (sx * sw) first, * acc, + bias in f32, cast;
  // + bf16(post), cast; + res, cast
  constexpr float kInvQmax2 = 0x1.040c2p-14f;   // f32(f32(1/127)^2), XLA's folded constant
  const float sxc = __fmul_rn(fmaxf(__ldg(p.stats), 1e-12f), kInvQmax2);
#pragma unroll
  for (int ni = 0; ni < T::kNI; ++ni) {
    const int col = n0 + wn * T::kWN + ni * 8 + 2 * t;
    if (col >= p.co) continue;
    const bool two = col + 1 < p.co;
    const bool pair = two && (p.co % 2 == 0);   // 4-byte aligned pair stores
    float s[2], b[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = two ? col + e : col;
      s[e] = __fmul_rn(__ldg(p.wamax + cc), sxc);
      if (p.bias) b[e] = __ldg(p.bias + cc);
    }
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int row = m0 + wm * T::kWM + mi * 16 + g + 8 * hlf;
        if (row >= p.m) continue;
        const size_t off = (size_t)row * p.co + col;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float y = __fmul_rn(__int2float_rn(acc[mi][ni][2 * hlf + e]), s[e]);
          if (p.bias) y = __fadd_rn(y, b[e]);
          y = round_bf16(y);
          if (e == 0 || two) {
            if (p.post) y = round_bf16(__fadd_rn(y, round_bf16(__ldg(p.post + (size_t)(row / p.hw) * p.co + col + e))));
            if (p.res) y = round_bf16(__fadd_rn(y, __bfloat162float(p.res[off + e])));
          }
          v[e] = y;
        }
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(p.out + off) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          p.out[off] = __float2bfloat16_rn(v[0]);
          if (two) p.out[off + 1] = __float2bfloat16_rn(v[1]);
        }
      }
  }
}

template <int BN, int kWarpsM, int kWarpsN, int kChunk, bool kConv, bool kRaw>
int launch(const Params& p, cudaStream_t s) {
  using T = Tile<BN, kWarpsM, kWarpsN, kChunk>;
  const auto kernel = gemm_kernel<BN, kWarpsM, kWarpsN, kChunk, kConv, kRaw>;
  int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes));
  if (err) return err;
  const dim3 grid((p.m + kBM - 1) / kBM, (p.co + BN - 1) / BN);
  kernel<<<grid, T::kThreads, T::kSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kChunk, bool kConv, bool kRaw = false>
int launch_width(const Params& p, int bn, cudaStream_t s) {
  if (bn == 128) return launch<128, 2, 4, kChunk, kConv, kRaw>(p, s);
  if (bn == 32) return launch<32, 4, 1, kChunk, kConv, kRaw>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace int8_gemm
}  // namespace

// a: dense (m, kdim) int8, or with conv = 1 the NHWC codes (n, h, w, ci)
// (m = n*h*w, kdim = 9*ci); b: (co, kdim) int8; stats: the activation's
// (amax, scale) f32 on the device (csrc/int8_quant.cu); wamax: (co) f32, the
// weights' amaxes clamped at 1e-12; bias:
// (co) f32 or null; post: (n, co) f32 or null (conv only); res, out:
// (m, co) bf16, res may be null; with stats null (dense only, no bias,
// post or res) the raw form: out is (m, co) int32, the exact sums. bn: 128
// or 32 (the wrapper's int8_gemm_plan);
// chunk: 16 where kdim (dense) or ci (conv) is a multiple of 16, else 4 (conv
// only, ci % 4 == 0). Returns the CUDA error of the launch, or
// cudaErrorInvalidValue for an argument this file does not take.
extern "C" int svdx_int8_gemm(const void* a, const void* b, const void* stats, const void* wamax,
                              const void* bias, const void* post, const void* res, void* out,
                              int m, int co, int kdim, int conv, int h, int w, int ci, int bn,
                              int chunk, void* stream) {
  using namespace int8_gemm;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p;
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.stats = static_cast<const float*>(stats);
  p.wamax = static_cast<const float*>(wamax);
  p.bias = static_cast<const float*>(bias);
  p.post = static_cast<const float*>(post);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.sums = static_cast<int32_t*>(out);
  p.m = m;
  p.co = co;
  p.kdim = kdim;
  p.h = h;
  p.wd = w;
  p.ci = ci;
  p.hw = conv ? h * w : (m > 0 ? m : 1);
  if (m <= 0 || co <= 0 || kdim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (conv) {
    if (kdim != 9 * ci || m % (h * w) || ci % chunk) return static_cast<int>(cudaErrorInvalidValue);
    if (chunk == 16) return launch_width<16, true>(p, bn, s);
    if (chunk == 4) return launch_width<4, true>(p, bn, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (post != nullptr || chunk != 16 || kdim % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (stats == nullptr) {
    if (wamax != nullptr || bias != nullptr || res != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_width<16, false, true>(p, bn, s);
  }
  return launch_width<16, false>(p, bn, s);
}
