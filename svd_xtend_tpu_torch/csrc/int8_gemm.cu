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
// multiply-add), and the int32 accumulator is exact, so the output is the
// plain version's bit for bit (ops/kernels/int8_gemm.py), whatever the
// order of the products and of a split's partial sums.
//
// Two A operands: dense rows a (M, K), or the 3x3 SAME implicit GEMM over
// NHWC int8 codes (M = N*H*W pixels, K = 9*Ci, k = tap*Ci + ci, tap = 3 dy +
// dx, the padding read as zeros). B is the weight codes, K-major: (Co, K),
// which for the conv is the OIHW weight's (Co, 3, 3, Ci) permute.
//
// What bounds it on an H100: at the UNet's L0 CFG site (28 x 40 x 64,
// 320 -> 320) 1.32e11 operations, 0.067 ms at the 1,979 TOP/s int8 rate,
// against 0.035 ms of bytes (int8 in, bf16 out): tensor-core bound at the
// convs, as the bf16 conv3x3 kernel is. The dense sites with wide outputs
// (the feed-forward's 2*4C projection) write 2 bytes an output against
// 2*K operations, and are bound by their bytes.
//
// Design: the persistent TMA + wgmma mainloop of csrc/sm90_gemm.cuh, shared
// with the bf16 GEMMs, on int8 operands (sm90_gemm::S8Ops): a producer
// warpgroup fills a ring of stages by TMA (the int8 codes as raw bytes; TMA's
// zero fill is code 0, the quantised SAME padding), two consumer warpgroups
// run wgmma m64nBNk32 .s32.s8.s8 on them with both operands K-major and
// int32 accumulators, and each warpgroup finishes its 64 rows of a tile in
// shared memory, which one of its threads stores by TMA while the next item's
// products run; a residual comes into those rows by the producer's TMA. A
// stage holds 128 codes of K for each row, one 128-byte swizzle atom as a
// bf16 stage holds, four k32 steps. The conv reads a K tile as 128 channels
// of one tap: A by TMA's im2col mode (one load a tap at its offsets, across
// rows and samples in pixel order), B as the (Ci, 9, Co) weight codes' box
// of the same tap and channels, so a tap whose Ci is not a multiple of 128
// ends in a tile whose surplus channels TMA fills with zeros in both
// operands (Ci 320: 3 tiles a tap, the last half zeros) and nothing is
// repacked. The plan (ops/kernels/int8_gemm.py::int8_gemm_plan) picks the
// tile width (128, 160, 256: .s8 wgmma takes every multiple of 16 up to
// 256), the K slices and the grid; where it splits K (the 5x8 level) the
// consumers write int32 partials and sums_kernel adds them and runs the
// epilogue (exact: any order gives the same bits). The raw form (dense
// only, stats null)
// stores the int32 tile as it is (a tile twice bf16's bytes, so fewer
// stages fit beside it). A row-parallel product under tensor parallelism
// (parallel/tensor.py) sums its ranks' int32 partials exactly over the model
// group and dequantises the sum once, so the output is the one-rank
// product's bit for bit (ops/kernels/int8_gemm.py::dense_sums).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; device time per launch in a
// CUDA graph; scripts/bench_gemm_plans.py: --int8 times every plan at every
// int8 site, --trees this tree beside copies of these files changed as
// named, each in its own process, in the same call):
//   - K tiles of 128 codes (3 a tap at Ci 320, the last half zeros) against
//     64 (64-byte swizzle, 5 a tap, none wasted; every Ci here a multiple):
//     the zero-filled channels cost tensor time but no bytes, against half
//     as many stages. With both built, the plan took 128 at every site but
//     the 2- and 28-row denses, and 64 there saved 0.6 % of the int8 GEMMs'
//     time a video; 64 was taken out (PERF.md §6, the int8 GEMM);
//   - the wide dense sites (the feed-forward's 2560-10240 columns after a
//     K of 320-1280) are bound by the epilogue's arithmetic more than by
//     their stores (copies without either: PERF.md §6, the int8 GEMM). What moved
//     them: no branch in the unrolled epilogue loop (a `continue` past the
//     last column cut it into one block an iteration, each waiting on its
//     own loads) and the dense's epilogue without the conv's shift and
//     residual at compile time: (71680, 320 -> 2560) 0.244 ms against 0.42
//     for the first version of this epilogue, and Σ 454.3 ms of dense GEMM
//     a video against 646.2, 472.0 with the branch, 538.1 with the run-time
//     flags;
//   - tried and taken out: the tile in 64-byte-swizzled 32-column blocks
//     (no bank conflicts on the epilogue's stores, 8-way in the row-major
//     tile at BN 256): 2 % slower a video; an exact int-to-float by seven ALU
//     instructions in place of I2F: 11 % slower.
//
// TMA needs 16-byte global strides, so the shapes it cannot take keep the
// first version of this kernel (int8_mma::gemm_kernel, mainloop 0): the
// UNet's conv_in (Ci 8) and the VAE decoder's (Ci 4), whose pixel rows are
// 8 and 4 bytes, and the thin outputs (Co <= 32: the UNet's conv_out, Co 4,
// and the decoder's, Co 3), whose bf16 output rows are 8 and 6 bytes and
// where a 128-wide tile would compute 32-42 times the columns it keeps. It is
// mma.sync m16n8k32 .s32.s8.s8 fed by ldmatrix from a 4-stage cp.async ring
// of 64-byte K tiles (two k32 steps), 128 x BN block tiles (BN 128: 8 warps
// of 64 x 32; BN 32: 4 warps of 32 x 32), non-persistent, the loaders
// computing each chunk's source (its tap, its shifted pixel, the padding as a
// zero fill), 16-byte chunks where Ci (conv) or K (dense) is a multiple of
// 16, 4-byte chunks otherwise, and thread-per-pair global stores of the
// accumulator layout. At the wide sites it measured 10-20 % of its bound
// (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's int8 kernel phase): its
// warp tiles were bound by shared-memory reads and its stores by their
// pattern, as the bf16 kernels' first versions were (csrc/sm90_gemm.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

// the tile widths the wgmma kernels instantiate (the plan picks one) and the
// bytes of K a stage holds
#define SVDX_INT8_TILE_N 128, 160, 256
#define SVDX_INT8_K_BYTES 128

namespace {

constexpr float kInvQmax2 = 0x1.040c2p-14f;   // f32(f32(1/127)^2), XLA's folded constant

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ------------------------------------------------ the mma.sync kernel --

namespace int8_mma {

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

}  // namespace int8_mma

// ---------------------------------------------------- the wgmma kernels --

namespace int8_wgmma {

constexpr int kKB = SVDX_INT8_K_BYTES;  // one 128-byte swizzle atom: 128 codes

// The dense A: (M, K) codes as boxes of (kKB bytes, 128 rows) through a 3-D
// map (M, K, 1); rows past M and columns past K read as zeros.
struct RowsA {
  struct Pos {
    int m0;
  };
  __device__ __forceinline__ Pos at(int m0) const { return {m0}; }
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       Pos p, int kt) const {
    sm90::tma_load_3d(dst, map, bar, kt * kKB, p.m0, 0);
  }
};

// The conv's A and B per tap: K tile kt is the channels (kt % cblocks) *
// kKB.. of tap kt / cblocks (cblocks = ceil(Ci / kKB)); A by one im2col load
// at the tap's offsets (as sm90_gemm::Im2colA<3>), B the box (kKB channels,
// the tap, BN output channels) of the (Ci, 9, Co) weight codes. Channels past
// Ci read as zeros in both.
struct TapsA {
  int cblocks;
  int h, w;
  struct Pos {
    int x, y, n;  // the item's first output pixel, less the padding
  };
  __device__ __forceinline__ Pos at(int m0) const {
    const int hw = h * w, n = m0 / hw, r = m0 - n * hw, y = r / w;
    return {r - y * w - 1, y - 1, n};
  }
  __device__ __forceinline__ void load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                       Pos p, int kt) const {
    const int tap = kt / cblocks, cb = kt - tap * cblocks, dy = tap / 3;
    sm90_gemm::tma_load_im2col(dst, map, bar, cb * kKB, p.x, p.y, p.n,
                               (uint16_t)(tap - 3 * dy), (uint16_t)dy);
  }
  __device__ __forceinline__ void load_b(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         Pos, int kt, int n0) const {
    const int tap = kt / cblocks;
    sm90::tma_load_3d(dst, map, bar, (kt - tap * cblocks) * kKB, tap, n0);
  }
};

struct EpiParams {
  const float* stats;        // (amax, scale) of a, on the device
  const float* wamax;        // (co) the weights' clamped amaxes
  const float* bias;         // (co) f32 or null
  const float* post;         // (m / hw, co) f32 or null
  const __nv_bfloat16* res;  // (m, co) or null
  void* out;                 // (m, co) bf16, or int32 in the raw form
  int m, co, hw;
};

template <class E>
__global__ void __launch_bounds__(256) sums_kernel(const sm90_gemm::Shape shape, const E epi);

// The dequantising epilogue (kRaw: the int32 sums as they are; kConv: with
// the conv's shift and residual, which a dense never has). The tile
// hook finishes a warpgroup's 64 rows in shared memory, where the producer
// brought the residual; reduce() runs the split-K sums through the same
// arithmetic from device memory. The tile is row-major; kOutCols counts its
// 2-byte columns, so the raw form's int32 tile is 2 * BN of them.
template <bool kRaw, bool kConv>
struct Epi {
  using Ops = sm90_gemm::S8Ops;
  static constexpr bool kPairs = false;
  static constexpr bool kStats = false;
  template <int BN>
  static constexpr int kOutCols = kRaw ? 2 * BN : BN;
  __device__ static int out_col(int n0) { return n0; }
  EpiParams p;

  __device__ __forceinline__ float sx() const {
    return __fmul_rn(fmaxf(__ldg(p.stats), 1e-12f), kInvQmax2);
  }
  // one output from its sum in JAX's order, before the last cast to bf16
  // (the caller's pack): f32(acc) * s (+ b), cast; + bf16(post), cast; + r.
  // has_post: the row's sample's shift `post` applies; r: the residual (read
  // with p.res). Rounding only before an add that follows keeps the values of
  // rounding after every step.
  __device__ __forceinline__ float finish(int32_t acc, float s, float b, bool has_post,
                                          float post, float r) const {
    float y = __fmul_rn(__int2float_rn(acc), s);
    if (p.bias) y = __fadd_rn(y, b);
    if (kConv && has_post) y = __fadd_rn(round_bf16(y), round_bf16(post));
    if (kConv && p.res) y = __fadd_rn(round_bf16(y), r);
    return y;
  }
  __device__ __forceinline__ float2 post_pair(const float* post, int col) const {
    return kConv && post ? __ldg(reinterpret_cast<const float2*>(post + col))
                         : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ const float* post_row(int row) const {
    return kConv && p.post && row < p.m ? p.post + (size_t)(row / p.hw) * p.co : nullptr;
  }
  template <int BN>
  __device__ __forceinline__ void tile(int32_t (&d)[BN / 2], int r0, int n0, int, int t,
                                       __nv_bfloat16* rows, int tr0) const {
    if constexpr (kRaw) {
      int32_t* o = reinterpret_cast<int32_t*>(rows) + tr0 * BN + 2 * t;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<int2*>(o + 8 * h * BN + 8 * j) =
              make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    } else {
      // No branch in the loop: columns past Co (the last N tile's) read the
      // last pair's vectors and are computed for nothing (the TMA store clips
      // them). A `continue` there cut the unrolled loop into one block an
      // iteration, each waiting for its own loads (see the top of the file).
      const float s0 = sx();
      const float* post[2] = {post_row(r0), post_row(r0 + 8)};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = min(n0 + 8 * j + 2 * t, p.co - 2);
        const float2 w = __ldg(reinterpret_cast<const float2*>(p.wamax + col));
        const float2 b = p.bias ? __ldg(reinterpret_cast<const float2*>(p.bias + col))
                                : make_float2(0.f, 0.f);
        const float sa = __fmul_rn(w.x, s0), sb = __fmul_rn(w.y, s0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t* q = reinterpret_cast<uint32_t*>(rows + (tr0 + 8 * h) * BN + 8 * j + 2 * t);
          float2 r = make_float2(0.f, 0.f);
          if (kConv && p.res) {
            const uint32_t raw = *q;
            r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
          }
          const float2 pv = post_pair(post[h], col);
          *q = sm90::pack_bf16(finish(d[4 * j + 2 * h], sa, b.x, post[h], pv.x, r.x),
                               finish(d[4 * j + 2 * h + 1], sb, b.y, post[h], pv.y, r.y));
        }
      }
    }
  }

  // the output pair (row, col), col even, from its int32 sums
  __device__ __forceinline__ void store_pair(int row, int col, int32_t a0, int32_t a1) const {
    const size_t off = (size_t)row * p.co + col;
    if constexpr (kRaw) {
      *reinterpret_cast<int2*>(static_cast<int32_t*>(p.out) + off) = make_int2(a0, a1);
    } else {
      const float s0 = sx();
      const float* post = post_row(row);
      const float2 pv = post_pair(post, col);
      const float b0 = p.bias ? __ldg(p.bias + col) : 0.f, b1 = p.bias ? __ldg(p.bias + col + 1) : 0.f;
      float2 r = make_float2(0.f, 0.f);
      if (kConv && p.res)
        r = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p.res + off)));
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.out) + off) = sm90::pack_bf16(
          finish(a0, __fmul_rn(__ldg(p.wamax + col), s0), b0, post, pv.x, r.x),
          finish(a1, __fmul_rn(__ldg(p.wamax + col + 1), s0), b1, post, pv.y, r.y));
    }
  }

  int reduce(const sm90_gemm::Shape& shape, cudaStream_t stream) const {
    const long long pairs = (long long)shape.m * shape.n / 2;
    const long long want = (pairs + 255) / 256, cap = 16LL * sm90_gemm::sm_count();
    int8_wgmma::sums_kernel<<<static_cast<int>(want < cap ? want : cap), 256, 0, stream>>>(
        shape, *this);
    return static_cast<int>(cudaGetLastError());
  }
};

// the split-K sums: out = epi(sum over slices 0..S-1 of the int32 partials),
// one column pair a thread
template <class E>
__global__ void __launch_bounds__(256) sums_kernel(const sm90_gemm::Shape shape, const E epi) {
  const long long pairs = (long long)shape.m * shape.n / 2;
  const size_t plane = (size_t)shape.m * shape.n;
  const int32_t* part = reinterpret_cast<const int32_t*>(shape.partial);
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < pairs;
       i += (long long)gridDim.x * 256) {
    const size_t e = (size_t)i * 2;
    int2 v = *reinterpret_cast<const int2*>(part + e);
    for (int s = 1; s < shape.k_slices; ++s) {
      const int2 q = *reinterpret_cast<const int2*>(part + s * plane + e);
      v.x += q.x;
      v.y += q.y;
    }
    epi.store_pair(static_cast<int>(e / shape.n), static_cast<int>(e % shape.n), v.x, v.y);
  }
}

// ------------------------------------------------------------ host maps --

// a tiled map over a contiguous int8 (batch, rows, cols) tensor, boxes of
// (kKB bytes, box_rows, box_batch) in the 128-byte swizzle; zeros past the
// edges. The dense A and B: (1, rows, K) in boxes of (kKB, tile rows, 1); the
// conv's B: (Co, 9, Ci) in boxes of (kKB, 1, BN), one tap's channels
static inline int encode_codes_map(CUtensorMap* map, const void* base, int cols, int rows,
                                   int batch, int box_rows, int box_batch) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || cols % 16 != 0 || rows < 1 || batch < 1 ||
      box_rows < 1 || box_rows > 256 || box_batch < 1 || box_batch > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::EncodeTiledFn fn = sm90::encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols, (cuuint64_t)cols * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)kKB, (cuuint32_t)box_rows, (cuuint32_t)box_batch};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the conv's im2col map over NHWC int8 codes (n, h, w, c), c % 16 == 0: a
// load brings 128 output pixels' kKB channels of one tap, zeros outside the
// image, past the last sample and past channel c (sm90_gemm::encode_im2col_map
// in bytes)
static inline int encode_codes_im2col(CUtensorMap* map, const void* base, int n, int h, int w,
                                      int c) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || c % 16 != 0 || n < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90_gemm::EncodeIm2colFn fn = sm90_gemm::encode_im2col_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const uint64_t pix = (uint64_t)c;
  const cuuint64_t strides[3] = {pix, pix * (uint64_t)w, pix * (uint64_t)w * (uint64_t)h};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(base), dims,
                        strides, lower, upper, (cuuint32_t)kKB, (cuuint32_t)sm90_gemm::kBM, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the raw form's output: a (rows, cols) int32 matrix in boxes of (box_cols,
// 64) from a dense row-major tile in shared memory, clipped at the edges
static inline int encode_sums_map(CUtensorMap* map, void* base, int cols, int rows,
                                  int box_cols) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || cols % 4 != 0 || rows < 1 ||
      box_cols > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::EncodeTiledFn fn = sm90::encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, base, dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

int launch(const void* a, const void* b, const EpiParams& ep, void* workspace, int kdim,
           bool conv, int h, int w, int ci, int bn, int k_slices, int grid, bool raw,
           cudaStream_t s) {
  const int m = ep.m, co = ep.co;
  CUtensorMap a_map, b_map, c_map, r_map;
  int err;
  int k_tiles;
  if (conv) {
    k_tiles = 9 * ((ci + kKB - 1) / kKB);
    err = encode_codes_im2col(&a_map, a, m / (h * w), h, w, ci);
    if (err == 0) err = encode_codes_map(&b_map, b, ci, 9, co, 1, bn);
  } else {
    k_tiles = (kdim + kKB - 1) / kKB;
    err = encode_codes_map(&a_map, a, kdim, m, 1, sm90_gemm::kBM, 1);
    if (err == 0) err = encode_codes_map(&b_map, b, kdim, co, 1, bn, 1);
  }
  if (err == 0 && raw) {
    err = encode_sums_map(&c_map, ep.out, co, m, bn);
    r_map = c_map;
  } else if (err == 0) {
    err = sm90_gemm::encode_tile_map(&c_map, ep.out, co, m, bn, 64);
    if (err == 0) err = sm90_gemm::encode_tile_map(&r_map, ep.res ? ep.res : ep.out, co, m, bn, 64);
  }
  if (err != 0) return err;
  const sm90_gemm::Shape shape{m, co, k_tiles, k_slices, static_cast<float*>(workspace),
                               ep.res != nullptr};
  if (conv) {
    const TapsA aload{(ci + kKB - 1) / kKB, h, w};
    return sm90_gemm::launch_tile<TapsA, Epi<false, true>, SVDX_INT8_TILE_N>(
        bn, a_map, b_map, c_map, r_map, shape, aload, Epi<false, true>{ep}, grid, s);
  }
  if (raw)
    return sm90_gemm::launch_tile<RowsA, Epi<true, false>, SVDX_INT8_TILE_N>(
        bn, a_map, b_map, c_map, r_map, shape, RowsA{}, Epi<true, false>{ep}, grid, s);
  return sm90_gemm::launch_tile<RowsA, Epi<false, false>, SVDX_INT8_TILE_N>(
      bn, a_map, b_map, c_map, r_map, shape, RowsA{}, Epi<false, false>{ep}, grid, s);
}

}  // namespace int8_wgmma
}  // namespace

// a: dense (m, kdim) int8, or with conv = 1 the NHWC codes (n, h, w, ci)
// (m = n*h*w, kdim = 9*ci); b: (co, kdim) int8 (the conv's (co, 3, 3, ci));
// stats: the activation's (amax, scale) f32 on the device
// (csrc/int8_quant.cu); wamax: (co) f32, the weights' amaxes clamped at
// 1e-12; bias: (co) f32 or null; post: (n, co) f32 or null (conv only); res,
// out: (m, co) bf16, res may be null; with stats null (dense only, no bias,
// post or res) the raw form: out is (m, co) int32, the exact sums. All
// contiguous. The plan (ops/kernels/int8_gemm.py::int8_gemm_plan):
//   - mainloop 1, the wgmma kernels: tile width bn (128, 160, 256),
//     k_slices K slices (of K tiles of 128 codes a tap) on `grid` persistent
//     blocks, workspace (k_slices, m, co) int32 when k_slices > 1, else
//     null; conv: ci % 16 == 0; dense: kdim % 16 == 0; co % 8 == 0 (the raw
//     form co % 4 == 0);
//   - mainloop 0, the mma.sync kernel: bn 128 or 32, one K slice; 16-byte
//     loads where ci (conv) or kdim (dense) is a multiple of 16, else 4-byte
//     (conv only, ci % 4 == 0); dense kdim % 16 == 0.
// Returns the first CUDA error of the launches, or cudaErrorInvalidValue for
// a plan or an argument this file does not take (a tensor map TMA refuses is
// found before anything launches).
extern "C" int svdx_int8_gemm(const void* a, const void* b, const void* stats, const void* wamax,
                              const void* bias, const void* post, const void* res, void* out,
                              void* workspace, int m, int co, int kdim, int conv, int h, int w,
                              int ci, int mainloop, int bn, int k_slices, int grid,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);
  const bool raw = stats == nullptr;
  if (m <= 0 || co <= 0 || kdim <= 0) return kInvalid;
  if (conv && (h <= 0 || w <= 0 || kdim != 9 * ci || m % (h * w))) return kInvalid;
  if (!conv && post != nullptr) return kInvalid;
  if (raw && (conv || wamax != nullptr || bias != nullptr || res != nullptr)) return kInvalid;
  if (mainloop == 1) {
    if ((conv && ci % 16) || (!conv && kdim % 16) || co % (raw ? 4 : 8)) return kInvalid;
    const int8_wgmma::EpiParams ep{static_cast<const float*>(stats),
                                   static_cast<const float*>(wamax),
                                   static_cast<const float*>(bias),
                                   static_cast<const float*>(post),
                                   static_cast<const __nv_bfloat16*>(res),
                                   out, m, co, conv ? h * w : m};
    return int8_wgmma::launch(a, b, ep, workspace, kdim, conv, h, w, ci, bn, k_slices, grid, raw,
                              s);
  }
  if (mainloop != 0 || k_slices != 1) return kInvalid;
  using namespace int8_mma;
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
  p.hw = conv ? h * w : m;
  if (conv) {
    if (ci % 16 == 0) return launch_width<16, true>(p, bn, s);
    if (ci % 4 == 0) return launch_width<4, true>(p, bn, s);
    return kInvalid;
  }
  if (kdim % 16) return kInvalid;
  if (raw) return launch_width<16, false, true>(p, bn, s);
  return launch_width<16, false>(p, bn, s);
}
