// Non-causal flash attention on the packed (B, S, H*64) layout: the forward
// kernel (the backward pair is csrc/flash_backward.cu).
//
// Replaces svd_xtend_tpu/ops/pallas/flash_attention.py::_fwd_packed_kernel
// (the spatial self-attention of every BasicTransformerBlock), read in place
// on the packed layout.
//
// What bounds it on an H100: at the slice's shapes (S = 2560 and 640 tokens,
// head_dim 64) attention does 4*S*S*64 FLOPs per (batch, head) against
// 4*S*64*2 bytes of q/k/v/o, i.e. ~S/2 FLOPs per byte -- far above the
// card's ~295 FLOP/byte ridge, so the tensor cores bound it. The design
// therefore keeps the S x S scores out of device memory entirely (online
// softmax, as the TPU kernel does) and runs both products on the tensor
// cores with mma.sync m16n8k16 bf16 -> f32.
//
// Layout: one block = 4 warps = 64 query rows of one (batch, head). Each
// warp owns 16 query rows; its Q fragments stay in registers for the whole
// KV loop. K and V tiles of 64 keys are staged in shared memory (V stored
// transposed so its B-operand fragments are 32-bit loads). The score
// accumulators are re-packed in registers as the A operand of P.V (the
// C-fragment of two n8 tiles is exactly the A-fragment of one k16 step), so
// P never leaves registers. Softmax statistics are f32, exp2 with
// scale*log2(e) folded into the scores. Ragged sequence ends are masked.
// When asked (training), the forward also writes the f32 log-sum-exp of
// each query row, (B, H, S) in natural-log units, for the backward.
//
// Not yet done (later work): TMA double buffering and wgmma, as the
// backward pair has them (csrc/sm90.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head dim
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kLds = kD + 8;   // smem row stride in bf16 (bank-conflict-free fragment loads)
constexpr int kThreads = 128;
constexpr float kMaskedScore = -1e30f;

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

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int s_q, int s_kv, int n_cols, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * kLds];
  __shared__ __align__(16) __nv_bfloat16 vts[kD * kLds];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)h * kD;
  const __nv_bfloat16* qb = q + (size_t)b * s_q * n_cols + head;
  const __nv_bfloat16* kb = k + (size_t)b * s_kv * n_cols + head;
  const __nv_bfloat16* vb = v + (size_t)b * s_kv * n_cols + head;
  __nv_bfloat16* ob = o + (size_t)b * s_q * n_cols + head;

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < s_q ? ld32(qb + (size_t)r0 * n_cols + c) : 0u;
    qa[kk][1] = r1 < s_q ? ld32(qb + (size_t)r1 * n_cols + c) : 0u;
    qa[kk][2] = r0 < s_q ? ld32(qb + (size_t)r0 * n_cols + c + 8) : 0u;
    qa[kk][3] = r1 < s_q ? ld32(qb + (size_t)r1 * n_cols + c + 8) : 0u;
  }

  float m[2] = {kMaskedScore, kMaskedScore};
  float l[2] = {0.f, 0.f};
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  for (int kv0 = 0; kv0 < s_kv; kv0 += kBK) {
    __syncthreads();  // the previous tile has been consumed by every warp
    for (int i = tid; i < kBK * (kD / 8); i += kThreads) {
      const int row = i >> 3, ch = (i & 7) * 8;
      const int key = kv0 + row;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < s_kv) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)key * n_cols + ch);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)key * n_cols + ch);
      }
      *reinterpret_cast<uint4*>(ks + row * kLds + ch) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) vts[(ch + j) * kLds + row] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kp = ks + (n * 8 + g) * kLds + kk * 16 + 2 * t;
        mma_bf16(s[n], qa[kk], ld32(kp), ld32(kp + 8));
      }
    }

    // online softmax (base 2); rows g (j = 0, 1) and g + 8 (j = 2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kv0 + n * 8 + 2 * t + (j & 1);
        const float val = key < s_kv ? s[n][j] * scale_log2 : kMaskedScore;
        s[n][j] = val;
        mx[j >> 1] = fmaxf(mx[j >> 1], val);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    const float alpha[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[n][j] - mx[j >> 1]);
        s[n][j] = p;
        rs[j >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P (16 x 64 keys, bf16) straight from the score registers
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* vp = vts + (n * 8 + g) * kLds + kk * 16 + 2 * t;
        mma_bf16(acc[n], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

  if (lse != nullptr && t == 0) {
    // natural-log LSE of the scaled scores: ln 2 * (m + log2 l)
    float* lb = lse + ((size_t)b * gridDim.y + h) * s_q;
    if (r0 < s_q) lb[r0] = (m[0] + log2f(l[0])) * 0.6931471805599453f;
    if (r1 < s_q) lb[r1] = (m[1] + log2f(l[1])) * 0.6931471805599453f;
  }
  const float inv0 = l[0] > 0.f ? 1.f / l[0] : 0.f;
  const float inv1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < s_q)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * n_cols + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < s_q)
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * n_cols + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

}  // namespace

// q: (b, s_q, heads*64), k/v: (b, s_kv, heads*64), o like q; all bf16,
// contiguous, 16-byte aligned; lse: f32 (b, heads, s_q) or null. Returns
// cudaGetLastError() after the launch.
extern "C" int svdx_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        void* o, void* lse, int b, int s_q, int s_kv,
                                        int heads, float scale, void* stream) {
  const dim3 grid((s_q + kBQ - 1) / kBQ, heads, b);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s_q, s_kv, heads * kD, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
