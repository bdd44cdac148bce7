// The flash-attention forward in four softmax organisations, on the
// head-major (B*H, S, 64) bf16 layout, output only.
//
// Replaces scripts/microbench_flash_variants.py::_kernel (launched by its
// `run`): the TPU probe that ablates how the online softmax is organised
// against the KV major tile. The four modes, as there:
//   base       statistics (max, rescale, exp) updated per KV sub-tile;
//   major      one max/rescale/exp pass per KV major tile;
//   major_exp2 major, with log2(e) folded into the scale and exp2;
//   nosoftmax  p = s * scale, l = sum p, out = (sum bf16(p) v) / l (1 where
//              l == 0): the products and the data movement alone.
//
// What bounds it on an H100: 4*S*S*64 FLOPs per (batch*head) against
// 4*S*64*2 bytes, ~S/2 FLOPs per byte at S >= 2304: the tensor cores. The
// design keeps the scores in registers (mma.sync m16n8k16 bf16 -> f32, P
// re-packed from the score accumulators as the A operand of P.V, as
// csrc/flash_attention.cu does) and never writes the S x S scores.
//
// The card's major tile is 128 keys, two 64-key sub-tiles, not the TPU's
// 512: a warp owns 16 query rows, and a 16 x 512 f32 score tile would be
// 256 registers a thread and spill. At 128 keys a warp holds 64 score
// registers, so `major` does one statistics pass per 128 keys where `base`
// does two (one per 64-key sub-tile).
//
// exp versus exp2: `base` and `major` call the accurate expf (jnp.exp's
// arithmetic: a range reduction around one MUFU.EX2), `major_exp2` calls
// exp2f (MUFU.EX2 with log2(e) already in the scale). __expf would compile
// to ex2.approx(x * log2e) and make the two modes the same instructions.
//
// Layout: one block = 4 warps = 64 query rows of one batch*head; K tiles of
// 128 keys are staged key-major in shared memory, V transposed (so its
// B-operand fragments are 32-bit loads). S must be a multiple of 128 (the
// TPU probe's _choose_block refuses the rest); the wrapper checks it.
//
// Not yet done (later work): cp.async / TMA double buffering, wgmma,
// ldmatrix, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;           // head dim
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 128;         // keys per major tile
constexpr int kLds = kD + 8;     // K row stride in bf16 (conflict-free fragment loads)
constexpr int kLdv = kBK + 8;    // V^T row stride in bf16
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum Mode { kBase = 0, kMajor = 1, kMajorExp2 = 2, kNoSoftmax = 3 };

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kMode>
__device__ __forceinline__ float exp_mode(float x) {
  return kMode == kMajorExp2 ? exp2f(x) : expf(x);
}

// Fold kN n8 tiles of raw scores s (16 rows x kN*8 keys, from key `k0` of
// the staged tile) into the running statistics and the output accumulator.
template <int kMode, int kN>
__device__ __forceinline__ void update(float (&s)[kN][4], int k0, const __nv_bfloat16* vts,
                                       float scale, float (&m)[2], float (&l)[2],
                                       float (&acc)[8][4], int g, int t) {
  float rs[2] = {0.f, 0.f};
  if (kMode == kNoSoftmax) {
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[n][j] *= scale;
        rs[j >> 1] += s[n][j];
      }
  } else {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[n][j] *= scale;
        mx[j >> 1] = fmaxf(mx[j >> 1], s[n][j]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha[2] = {exp_mode<kMode>(m[0] - mx[0]), exp_mode<kMode>(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp_mode<kMode>(s[n][j] - mx[j >> 1]);
        s[n][j] = p;
        rs[j >> 1] += p;
      }
    l[0] *= alpha[0];
    l[1] *= alpha[1];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] += rs[r];
  }
  // O += bf16(P) V, P straight from the score registers
#pragma unroll
  for (int kk = 0; kk < kN / 2; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* vp = vts + (n * 8 + g) * kLdv + k0 + kk * 16 + 2 * t;
      mma_bf16(acc[n], pa, ld32(vp), ld32(vp + 8));
    }
  }
}

// s = Q K^T for a warp's 16 rows and kN*8 keys of the staged tile from `k0`.
template <int kN>
__device__ __forceinline__ void scores(float (&s)[kN][4], const uint32_t (&qa)[4][4],
                                       const __nv_bfloat16* ks, int k0, int g, int t) {
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* kp = ks + (k0 + n * 8 + g) * kLds + kk * 16 + 2 * t;
      mma_bf16(s[n], qa[kk], ld32(kp), ld32(kp + 8));
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
flash_variant_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int s_q, int s_kv, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * kLds];
  __shared__ __align__(16) __nv_bfloat16 vts[kD * kLdv];

  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = q + (size_t)bh * s_q * kD;
  const __nv_bfloat16* kb = k + (size_t)bh * s_kv * kD;
  const __nv_bfloat16* vb = v + (size_t)bh * s_kv * kD;
  __nv_bfloat16* ob = o + (size_t)bh * s_q * kD;

  // S is a multiple of 128, so every row and key is in range
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld32(qb + (size_t)r0 * kD + c);
    qa[kk][1] = ld32(qb + (size_t)r1 * kD + c);
    qa[kk][2] = ld32(qb + (size_t)r0 * kD + c + 8);
    qa[kk][3] = ld32(qb + (size_t)r1 * kD + c + 8);
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  for (int kv0 = 0; kv0 < s_kv; kv0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBK * (kD / 8); i += kThreads) {
      const int row = i >> 3, ch = (i & 7) * 8;
      const size_t off = (size_t)(kv0 + row) * kD + ch;
      *reinterpret_cast<uint4*>(ks + row * kLds + ch) = *reinterpret_cast<const uint4*>(kb + off);
      const uint4 vv4 = *reinterpret_cast<const uint4*>(vb + off);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) vts[(ch + j) * kLdv + row] = ve[j];
    }
    __syncthreads();

    if (kMode == kBase) {
#pragma unroll
      for (int sub = 0; sub < kBK; sub += 64) {
        float s[8][4];
        scores(s, qa, ks, sub, g, t);
        update<kMode, 8>(s, sub, vts, scale, m, l, acc, g, t);
      }
    } else {
      float s[16][4];
      scores(s, qa, ks, 0, g, t);
      update<kMode, 16>(s, 0, vts, scale, m, l, acc, g, t);
    }
  }

  const float inv0 = 1.f / (l[0] == 0.f ? 1.f : l[0]);
  const float inv1 = 1.f / (l[1] == 0.f ? 1.f : l[1]);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * kD + c) =
        pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * kD + c) =
        pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

}  // namespace

// q: (bh, s_q, 64), k/v: (bh, s_kv, 64), o like q; bf16, contiguous,
// 16-byte aligned; s_q and s_kv multiples of 128; mode 0-3 as Mode.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unknown mode).
extern "C" int svdx_flash_variant_fwd(const void* q, const void* k, const void* v, void* o,
                                      int bh, int s_q, int s_kv, float scale, int mode,
                                      void* stream) {
  const dim3 grid(s_q / kBQ, bh);
  const float sc = mode == kMajorExp2 ? scale * kLog2e : scale;
  auto qp = static_cast<const __nv_bfloat16*>(q);
  auto kp = static_cast<const __nv_bfloat16*>(k);
  auto vp = static_cast<const __nv_bfloat16*>(v);
  auto op = static_cast<__nv_bfloat16*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBase:
      flash_variant_kernel<kBase><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, s_q, s_kv, sc);
      break;
    case kMajor:
      flash_variant_kernel<kMajor><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, s_q, s_kv, sc);
      break;
    case kMajorExp2:
      flash_variant_kernel<kMajorExp2><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, s_q, s_kv,
                                                                  sc);
      break;
    case kNoSoftmax:
      flash_variant_kernel<kNoSoftmax><<<grid, kThreads, 0, st>>>(qp, kp, vp, op, s_q, s_kv,
                                                                  sc);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
