// 3x3 stride-1 SAME convolution on NHWC bf16 activations, with the fused
// epilogues of the GN-folded ResnetBlock2D:
//
//   y = conv3x3([silu](x*sc + sh)) + b [+ post[n, co]] [+ res]
//
// Replaces svd_xtend_tpu/ops/pallas/conv3x3.py::_kernel (its
// _conv3x3_fwd_impl), which the JAX package's backward also runs for dU
// (_conv3x3_vjp_bwd): the same kernel here, on dy with the flipped,
// in/out-swapped weight and no epilogue. Numerics as the TPU kernel and
// conv3x3_fused_reference: the per-(sample, channel) f32 affine (+ SiLU)
// rounded to bf16 before the product, with SAME padding that stays zero
// after the transform; bf16 products accumulated in f32; bias, the f32
// shift and the bf16 residual added in f32; one cast.
//
// What bounds it on an H100: 2*M*9*Ci*Co FLOPs (M = N*H*W output pixels)
// against about 2*M*(Ci + Co) bytes, i.e. 9*Ci*Co/(Ci + Co) FLOP/byte:
// 1440 at Ci = Co = 320, 5760 at 1280. Tensor-core bound at every UNet and
// VAE site: about 5.8 ms of tensor time per CFG UNet step against about
// 1.0 ms of device-memory bytes.
//
// Design: an implicit GEMM (M = N*H*W, N = Co, K = 9*Ci, k = tap*Ci + ci,
// tap = 3 dy + dx) on the shared Hopper mainloop of csrc/sm90_gemm.cuh:
// persistent blocks, a producer warpgroup filling a ring of A/B stages by
// TMA, consumer warpgroups running wgmma m64nBNk16 with both operands
// K-major in shared memory. A K tile is 64 channels of one tap. The A tile
// (BM output pixels x 64 channels) comes by TMA's im2col mode over the NHWC
// input (sm90_gemm::Im2colA<3>): one load per tap at its (dx, dy) offsets, the
// box running across rows and samples in pixel order, the SAME padding and
// the pixels past the last sample read as zeros by the hardware. No thread
// computes an address or a padding flag. The B tile is BN rows of the
// (Co, 9*Ci) weight by a 2-D map. The epilogue (ConvEpi) adds the bias, the
// per-(sample, channel) shift at each row's own sample (a 128-row tile spans
// samples at the 5x8 and 10x16 levels) and the residual in f32, one cast.
// Where few tiles would leave SMs idle (the 5x8 level), the K tiles are
// split into slices whose f32 partials sm90_gemm::reduce_kernel adds in a
// fixed order. The tile width BN (128-row tiles), the K slices and the grid
// are the plan's (ops/kernels/conv3x3.py::conv3x3_plan, a pure function of
// the shape); this file takes them and refuses what it does not instantiate.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, device time per launch in a
// CUDA graph; scripts/bench_gemm_plans.py): the L0 CFG forward (28x40x64,
// 320 -> 320) with its prologue and shift 0.284 ms, with its prologue and
// residual 0.264, against the mma.sync kernel's 0.636 and F.conv2d's
// 0.267-0.270 alone; the 10x16 level 0.145-0.434 (F.conv2d 0.136-0.385);
// the 5x8 level 0.079-0.139 against the mma.sync kernel's 0.231-0.447 and
// F.conv2d's 0.075-0.137; the L0 dU 0.125 against F.conv2d's 0.139. Of the
// L0 forward's time the prologue pass is 0.04 ms, the shift's epilogue 0.03
// (source note of sm90_gemm.cuh). TMA im2col needed no care beyond its map
// (the corners below); its boxes run across rows and samples as the
// 128-pixel tiles do.
//
// The affine + SiLU prologue runs as its own pass (csrc/affine_silu.cuh,
// shared with the temporal resnet), u = bf16([silu](x*sc + sh)) through
// device memory, which the conv then reads with its zero
// padding (so the padding stays zero). Why not in the conv's loads, as the
// TPU kernel does: with a per-tap K loop every input element is loaded, and
// would be transformed, 9 times per column block. The first version of PR
// 3's kernel did that, in shared memory after each stage landed: 2.04 ms at
// the L0 CFG site (28x40x64, 320 -> 320, 65 TFLOP/s) against 0.44 ms for
// the same conv at batch 14 without a prologue (H100 80GB HBM3, 700 W). The
// separate pass moves 2*|x| bytes once (92 MB, about 30 us at L0 CFG).
//
// Two sources (the up-block resnets' conv1, the JAX package's split-concat
// form, svd_xtend_tpu/models/blocks.py:_conv3x3_split_cat): the input is the
// channel concat [x, x2] of the running features (c1 channels) and a skip.
// The prologue pass reads both and writes u at c1 + c2 channels; the GEMM
// then reads u as it does for one source, so the mainloop is unchanged and
// no torch.cat pass (read both, write the concat) runs before it. A second
// A tensor map over x2 (K tiles past c1 loaded from it) would skip nothing
// here: the prologue writes u anyway, and the GEMM's loads are u's.
//
// Where Ci % 64 != 0 (the UNet's conv_in, Ci 8) a K tile of 64 channels of
// one tap does not exist; the plan sends those calls to the first mainloop,
// kept below (conv3x3_kernel): mma.sync m16n8k16 fed by ldmatrix from a
// 4-stage cp.async ring, 128 x BN x 32 tiles in 8 warps, each 16-byte chunk
// of A fetched from its shifted source pixel and zero-filled where the tap
// falls outside the image. That design measured 198-204 TFLOP/s at the L0
// site (0.643 ms against F.conv2d's 0.295): its 32 x 32 and 64 x 32 warp
// tiles were bound by shared-memory reads (4 warps of 64 x 64 measured
// slower still), its blocks were not persistent, and at the 5x8 level 90 or
// fewer blocks sat on 132 SMs (H100 80GB HBM3, 700 W).
//
// Weights: (Co, 3, 3, Ci) contiguous, i.e. (Co, 9*Ci) row-major, K-contiguous
// per output channel; the module stores its OIHW parameter in channels_last,
// whose permute is exactly this layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "affine_silu.cuh"
#include "sm90_gemm.cuh"

// the tile widths BN the TMA mainloop instantiates (the plan picks one)
#define SVDX_CONV_TILE_N 8, 128, 160, 256

namespace {

constexpr int kBM = 128;
constexpr int kBK = 32;
constexpr int kStages = 4;
constexpr int kLds = kBK + 8;  // rows padded by 16 bytes: conflict-free ldmatrix
constexpr int kChunks = kBK / 8;  // 16-byte chunks per row of a K tile

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

// A 128 x BN block tile in kWarpsM x kWarpsN warps of kWM x kWN. A thread
// loads one 16-byte chunk of rows r, r + kRowStep, ... of the A and B
// tiles.
template <int BN, int kWarpsM, int kWarpsN>
struct Tile {
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kWM = kBM / kWarpsM;
  static constexpr int kWN = BN / kWarpsN;
  static constexpr int kMI = kWM / 16;  // m16 blocks per warp
  static constexpr int kNI = kWN / 8;   // n8 blocks per warp
  static constexpr int kRowStep = kThreads / kChunks;
  static constexpr int kARows = kBM / kRowStep;
  static constexpr int kBRows = BN / kRowStep;
  static constexpr int kStageElems = (kBM + BN) * kLds;
  static constexpr int kSmemBytes = kStages * kStageElems * 2;
};

struct Params {
  const __nv_bfloat16* x;    // (N, H, W, Ci): the conv's input u
  const __nv_bfloat16* wt;   // (Co, 9*Ci)
  const float* bias;         // (Co) or null
  const float* post;         // (N, Co) or null
  const __nv_bfloat16* res;  // (N, H, W, Co) or null
  __nv_bfloat16* out;        // (N, H, W, Co)
  int h, wd, ci, co, m;      // m = N*H*W
};

// The source of the A chunk at K offset k for an output pixel (n, y, x) of
// flat index m: true and the element offset into x if the tap lands inside
// the image (and k < 9*Ci); false for padding.
__device__ __forceinline__ bool a_source(const Params& p, int k, bool row_ok, int m, int y,
                                         int xcol, size_t& off, int& ci) {
  if (!row_ok || k >= 9 * p.ci) return false;
  const int tap = k / p.ci;
  ci = k - tap * p.ci;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const int ys = y + dy, xs = xcol + dx;
  if (ys < 0 || ys >= p.h || xs < 0 || xs >= p.wd) return false;
  off = (size_t)(m + dy * p.wd + dx) * p.ci + ci;
  return true;
}

// kTapAligned (Ci % 32 == 0): a K tile is 32 channels of one tap, and the
// loader walks the taps in order, so a thread's A source rows and their
// padding flags change once per tap, not per tile.
template <int BN, int kWarpsM, int kWarpsN, bool kTapAligned>
__global__ void __launch_bounds__(32 * kWarpsM * kWarpsN)
conv3x3_kernel(const Params p) {
  using T = Tile<BN, kWarpsM, kWarpsN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int kdim = 9 * p.ci;
  const int hw = p.h * p.wd;

  // this thread's A rows (tile rows r, r + kRowStep, ...) and chunk column
  const int r0 = tid / kChunks, ch = (tid % kChunks) * 8;
  int a_m[T::kARows], a_y[T::kARows], a_x[T::kARows];
  bool a_ok[T::kARows];
#pragma unroll
  for (int j = 0; j < T::kARows; ++j) {
    const int m = m0 + r0 + T::kRowStep * j;
    a_ok[j] = m < p.m;
    a_m[j] = m;
    const int rem = m - (m / hw) * hw;
    a_y[j] = rem / p.wd;
    a_x[j] = rem - a_y[j] * p.wd;
  }

  // this thread's B rows, K-contiguous
  const __nv_bfloat16* b_src[T::kBRows];
  bool b_ok[T::kBRows];
#pragma unroll
  for (int i = 0; i < T::kBRows; ++i) {
    const int co = n0 + r0 + T::kRowStep * i;
    b_ok[i] = co < p.co;
    b_src[i] = p.wt + (b_ok[i] ? (size_t)co * kdim + ch : 0);
  }

  float acc[T::kMI][T::kNI][4];
#pragma unroll
  for (int i = 0; i < T::kMI; ++i)
#pragma unroll
    for (int j = 0; j < T::kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the tap-aligned loader's position (the next tile's tap and channel
  // offset) and this thread's A source rows for that tap
  int l_tap = 0, l_ci = 0;
  const __nv_bfloat16* l_src[T::kARows];
  bool l_ok[T::kARows];
  auto set_tap = [&](int tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int j = 0; j < T::kARows; ++j) {
      const int ys = a_y[j] + dy, xs = a_x[j] + dx;
      l_ok[j] = a_ok[j] && ys >= 0 && ys < p.h && xs >= 0 && xs < p.wd;
      l_src[j] = p.x + (l_ok[j] ? (size_t)(a_m[j] + dy * p.wd + dx) * p.ci + ch : 0);
    }
  };
  if (kTapAligned) set_tap(0);

  // tiles are loaded in order kt = 0, 1, ...
  auto load = [&](int stage, int kt) {
    __nv_bfloat16* as = smem + stage * T::kStageElems;
    __nv_bfloat16* bs = as + kBM * kLds;
    const int k = kt * kBK + ch;
#pragma unroll
    for (int j = 0; j < T::kARows; ++j) {
      __nv_bfloat16* dst = as + (r0 + T::kRowStep * j) * kLds + ch;
      if (kTapAligned) {
        cp_async16(dst, l_src[j] + l_ci, l_ok[j]);
      } else {
        size_t off = 0;
        int ci = 0;
        const bool ok = a_source(p, k, a_ok[j], a_m[j], a_y[j], a_x[j], off, ci);
        cp_async16(dst, p.x + (ok ? off : 0), ok);
      }
    }
    if (kTapAligned) {
      l_ci += kBK;
      if (l_ci == p.ci) {
        l_ci = 0;
        if (++l_tap < 9) set_tap(l_tap);
      }
    }
#pragma unroll
    for (int i = 0; i < T::kBRows; ++i) {
      const bool ok = b_ok[i] && k < kdim;
      cp_async16(bs + (r0 + T::kRowStep * i) * kLds + ch, ok ? b_src[i] + kt * kBK : p.wt, ok);
    }
  };

  const int kt_n = (kdim + kBK - 1) / kBK;
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

    const __nv_bfloat16* as = smem + (kt % kStages) * T::kStageElems;
    const __nv_bfloat16* bs = as + kBM * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[T::kMI][4];
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
        ldmatrix_x4(af[mi], as + (wm * T::kWM + mi * 16 + (lane & 15)) * kLds + kk +
                                (lane >> 4) * 8);
      uint32_t bf[T::kNI / 2][4];
#pragma unroll
      for (int nj = 0; nj < T::kNI / 2; ++nj)
        ldmatrix_x4(bf[nj], bs + (wn * T::kWN + nj * 16 + (lane >> 4) * 8 + (lane & 7)) * kLds +
                                kk + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::kNI; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2], bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: + bias [+ post[n, co]] [+ res] in f32, one cast
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < T::kNI; ++ni) {
    const int col = n0 + wn * T::kWN + ni * 8 + 2 * t;
    if (col >= p.co) continue;
    const float b0 = p.bias ? p.bias[col] : 0.f, b1 = p.bias ? p.bias[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int row = m0 + wm * T::kWM + mi * 16 + g + 8 * hlf;
        if (row >= p.m) continue;
        float v0 = acc[mi][ni][2 * hlf] + b0, v1 = acc[mi][ni][2 * hlf + 1] + b1;
        if (p.post) {
          const float* pp = p.post + (size_t)(row / hw) * p.co + col;
          v0 += pp[0];
          v1 += pp[1];
        }
        const size_t off = (size_t)row * p.co + col;
        if (p.res) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.res + off));
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<uint32_t*>(p.out + off) = pack_bf16(v0, v1);
      }
  }
}

template <int BN, int kWarpsM, int kWarpsN, bool kTapAligned>
int launch(const Params& p, cudaStream_t s) {
  using T = Tile<BN, kWarpsM, kWarpsN>;
  const auto kernel = conv3x3_kernel<BN, kWarpsM, kWarpsN, kTapAligned>;
  int err = static_cast<int>(cudaFuncSetAttribute(kernel,
                                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  T::kSmemBytes));
  if (err) return err;
  const dim3 grid((p.m + kBM - 1) / kBM, (p.co + BN - 1) / BN);
  kernel<<<grid, T::kThreads, T::kSmemBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, int kWarpsM, int kWarpsN>
int launch_tile(const Params& p, cudaStream_t s) {
  return p.ci % kBK == 0 ? launch<BN, kWarpsM, kWarpsN, true>(p, s)
                         : launch<BN, kWarpsM, kWarpsN, false>(p, s);
}

// The epilogue of the TMA mainloop: + bias [+ post[sample(row), co]] [+ res]
// in f32, one cast.
struct ConvEpi {
  static constexpr bool kPairs = true;
  static constexpr bool kStats = false;
  template <int BN>
  static constexpr int kOutCols = BN;
  __device__ static int out_col(int n0) { return n0; }
  const float* bias;         // (Co) or null
  const float* post;         // (N, Co) or null
  const __nv_bfloat16* res;  // (N, H, W, Co) or null
  __nv_bfloat16* out;        // (N, H, W, Co)
  int co, hw;
  struct Row {
    const float* post;  // the row's sample's shift, or null
  };
  __device__ __forceinline__ Row row(int r) const {
    return {post ? post + (size_t)(r / hw) * co : nullptr};
  }
  __device__ __forceinline__ float2 residual(int r, int col) const {
    return res ? __bfloat1622float2(
                     __ldg(reinterpret_cast<const __nv_bfloat162*>(res + (size_t)r * co + col)))
               : make_float2(0.f, 0.f);
  }
  __device__ __forceinline__ void finish(const Row& rw, int col, float2 r, float& v0,
                                         float& v1) const {
    if (bias) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
      v0 += b.x;
      v1 += b.y;
    }
    if (rw.post) {
      const float2 pp = __ldg(reinterpret_cast<const float2*>(rw.post + col));
      v0 += pp.x;
      v1 += pp.y;
    }
    v0 += r.x;
    v1 += r.y;
  }
  __device__ __forceinline__ void store(int row, int col, float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + (size_t)row * co + col) = pack_bf16(v0, v1);
  }
};

}  // namespace

// x: (n, h, w, ci) bf16, or with x2 its first c1 channels (n, h, w, c1)
// and x2 the other ci - c1 (n, h, w, ci - c1), c1 % 8 == 0, which needs the
// prologue (sc given); without x2, c1 is not read; wt: (co, 3, 3, ci) bf16;
// bias: (co,) f32 or null;
// sc, sh: (n, ci) f32, both or neither (null: no prologue); silu applies
// only with them; u: (n, h, w, ci) bf16 scratch for the prologue's output
// (null without sc); post: (n, co) f32 or null; res, out: (n, h, w, co)
// bf16, res may be null; workspace: (k_slices, n*h*w, co) f32 when
// k_slices > 1, else null. All contiguous; ci % 8 == 0 and co % 8 == 0 (the
// wrapper checks). The plan (conv3x3_plan): mainloop 1 = the TMA + wgmma
// mainloop (ci % 64 == 0) with tile width bn, the K split and `grid`
// persistent blocks; mainloop 0 = the mma.sync kernel, bn 128. Returns the first CUDA error of the launches (0
// on success), or cudaErrorInvalidValue for a plan this file does not take
// (a tensor map TMA refuses is found before anything launches).
extern "C" int svdx_conv3x3(const void* x, const void* x2, const void* wt, const void* bias,
                            const void* sc, const void* sh, void* u, const void* post,
                            const void* res, void* out, void* workspace, int n, int h, int w,
                            int ci, int c1, int co, int silu, int mainloop, int bn, int k_slices,
                            int grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = n * h * w;
  if (x2 != nullptr && (sc == nullptr || c1 < 8 || c1 % 8 || c1 >= ci))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap a_map, b_map, c_map, r_map;
  if (mainloop == 1) {
    int err = sm90_gemm::encode_im2col_map(&a_map, sc ? u : x, n, h, w, ci, 3, sm90_gemm::kBM);
    if (err == 0) err = sm90_gemm::encode_matrix_map(&b_map, wt, 9 * ci, co, bn);
    if (err == 0) err = sm90_gemm::encode_tile_map(&c_map, out, co, m, bn, 64);
    if (err == 0) err = sm90_gemm::encode_tile_map(&r_map, res ? res : out, co, m, bn, 64);
    if (err != 0) return err;
  } else if (mainloop != 0 || bn != 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const __nv_bfloat16* xin = static_cast<const __nv_bfloat16*>(x);
  if (sc) {
    const int err = affine_silu::launch(x, sc, sh, u, m, ci, h * w, silu != 0, s, x2, c1);
    if (err) return err;
    xin = static_cast<const __nv_bfloat16*>(u);
  }
  if (mainloop == 1) {
    const sm90_gemm::Shape shape{m, co, 9 * ci / sm90_gemm::kBK, k_slices,
                                 static_cast<float*>(workspace), res != nullptr};
    const sm90_gemm::Im2colA<3> aload{ci / sm90_gemm::kBK, h, w};
    const ConvEpi epi{static_cast<const float*>(bias), static_cast<const float*>(post),
                      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(out),
                      co, h * w};
    return sm90_gemm::launch_tile<sm90_gemm::Im2colA<3>, ConvEpi, SVDX_CONV_TILE_N>(
        bn, a_map, b_map, c_map, r_map, shape, aload, epi, grid, s);
  }
  Params p;
  p.x = xin;
  p.wt = static_cast<const __nv_bfloat16*>(wt);
  p.bias = static_cast<const float*>(bias);
  p.post = static_cast<const float*>(post);
  p.res = static_cast<const __nv_bfloat16*>(res);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.h = h;
  p.wd = w;
  p.ci = ci;
  p.co = co;
  p.m = m;
  return launch_tile<128, 2, 4>(p, s);
}
