// Non-causal flash attention on the packed (B, S, H*64) layout: the forward
// and the two backward kernels.
//
// Replaces svd_xtend_tpu/ops/pallas/flash_attention.py::_fwd_packed_kernel
// (the spatial self-attention of every BasicTransformerBlock) and its
// backward pair _dq_kernel / _dkv_kernel (the TPU path transposes to
// head-major around them, flash_attention.py:597-616; these read the packed
// layout in place, as the forward does).
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
// Backward (FA-2 split, as the JAX package: no atomics, deterministic):
//   P = exp(S*scale - LSE), dP = dO V^T, dS = P * (dP - delta) * scale,
//   dQ = dS K, dK = dS^T Q, dV = P^T dO, delta = rowsum(dO * O) (f32,
//   computed by the wrapper).
// dQ kernel: one block per (64-query tile, head, batch), looping over KV
// tiles; each warp keeps its 16 rows of Q and dO as mma A fragments in
// registers and its dQ accumulator in f32 registers; K is staged twice in
// shared memory (key-major for QK^T, transposed for dS K), V key-major.
// dK/dV kernel: one block per (64-key tile, head, batch), looping over query
// tiles; each warp keeps its 16 keys of K and V as A fragments and works on
// the transposed problem (S^T = K Q^T, dP^T = V dO^T), so P^T and dS^T are
// re-packed from their accumulators as the A operand of P^T dO and dS^T Q
// (never in shared memory); Q and dO are staged both ways. dS enters dQ and
// dK as a two-term bf16 split (hi + lo): rounding it to bf16 once, as the
// TPU kernel does, made the kernel's dQ/dK error up to 1.7x that of the
// plain bf16 PyTorch gradient at S = 40 (H100 test), with the split it is
// below it. P enters dV rounded once. The backward does 3.5x the forward's
// tensor-core FLOPs (7 products of the same size against 2) and is bound by
// the tensor cores like the forward.
//
// Not yet done (later work): cp.async / TMA double buffering, wgmma,
// ldmatrix, warp specialisation.

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

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// A fragments (16 rows x 64 columns, bf16) of rows r0 and r0 + 8 of a packed
// (rows, n_cols) matrix; rows at or past n_rows read as zero.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4], const __nv_bfloat16* base,
                                            int r0, int n_rows, int n_cols, int t) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = r0 < n_rows ? ldg32(base + (size_t)r0 * n_cols + c) : 0u;
    a[kk][1] = r1 < n_rows ? ldg32(base + (size_t)r1 * n_cols + c) : 0u;
    a[kk][2] = r0 < n_rows ? ldg32(base + (size_t)r0 * n_cols + c + 8) : 0u;
    a[kk][3] = r1 < n_rows ? ldg32(base + (size_t)r1 * n_cols + c + 8) : 0u;
  }
}

// Stage a 64-row tile of one head (rows row0.., 64 columns) into shared
// memory, row-major into `rm` and, when `tr` is given, transposed into `tr`
// (tr[col * kLds + row]); rows at or past n_rows are zero.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* rm, __nv_bfloat16* tr,
                                           const __nv_bfloat16* base, int row0,
                                           int n_rows, int n_cols, int tid) {
  for (int i = tid; i < 64 * (kD / 8); i += kThreads) {
    const int row = i >> 3, ch = (i & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row < n_rows)
      val = *reinterpret_cast<const uint4*>(base + (size_t)(row0 + row) * n_cols + ch);
    *reinterpret_cast<uint4*>(rm + row * kLds + ch) = val;
    if (tr != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(ch + j) * kLds + row] = e[j];
    }
  }
}

// acc[n] (16 x 64, n = 8-column tiles) += A (16 x 64, C fragments `c` of
// eight n8 tiles, re-packed to bf16) @ B, where B's 64 x 64 tile is stored
// transposed in shared memory (bt[col * kLds + k]). With kSplit, A enters as
// two bf16 terms, hi = bf16(c) and lo = bf16(c - hi), so the product sees c
// to ~16 bits instead of 8 (one more mma per tile).
template <bool kSplit>
__device__ __forceinline__ void mma_packed_a(float (&acc)[8][4], const float (&c)[8][4],
                                             const __nv_bfloat16* bt, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* src = c[2 * kk + (i >> 1)] + 2 * (i & 1);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(src[0], src[1]);
      pa[i] = *reinterpret_cast<const uint32_t*>(&hi);
      if (kSplit) {
        const float2 hf = __bfloat1622float2(hi);
        pl[i] = pack_bf16(src[0] - hf.x, src[1] - hf.y);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* bp = bt + (n * 8 + g) * kLds + kk * 16 + 2 * t;
      const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
      mma_bf16(acc[n], pa, b0, b1);
      if (kSplit) mma_bf16(acc[n], pl, b0, b1);
    }
  }
}

// c[n] = A (register fragments, 16 x 64) @ B^T, B a 64 x 64 row-major tile
// in shared memory (b[row * kLds + k]); c has 64 columns = B's rows.
__device__ __forceinline__ void mma_regs_a(float (&c)[8][4], const uint32_t (&a)[4][4],
                                           const __nv_bfloat16* b, int g, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) c[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* bp = b + (n * 8 + g) * kLds + kk * 16 + 2 * t;
      mma_bf16(c[n], a[kk], ld32(bp), ld32(bp + 8));
    }
  }
}

__device__ __forceinline__ void store_rows(__nv_bfloat16* base, const float (&acc)[8][4],
                                           int r0, int n_rows, int n_cols, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (size_t)r0 * n_cols + c) =
          pack_bf16(acc[n][0], acc[n][1]);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (size_t)(r0 + 8) * n_cols + c) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
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

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int s_q, int s_kv, int n_cols,
                    float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * kLds];
  __shared__ __align__(16) __nv_bfloat16 kts[kD * kLds];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * kLds];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)h * kD;
  const size_t qoff = (size_t)b * s_q * n_cols + head;
  const size_t kvoff = (size_t)b * s_kv * n_cols + head;
  const float* lse_b = lse + ((size_t)b * gridDim.y + h) * s_q;
  const float* delta_b = delta + ((size_t)b * gridDim.y + h) * s_q;

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[4][4], da[4][4];
  load_a_rows(qa, q + qoff, r0, s_q, n_cols, t);
  load_a_rows(da, dout + qoff, r0, s_q, n_cols, t);
  // base-2 LSE of each row, and delta
  const float l2[2] = {r0 < s_q ? lse_b[r0] * 1.4426950408889634f : 0.f,
                       r1 < s_q ? lse_b[r1] * 1.4426950408889634f : 0.f};
  const float dl[2] = {r0 < s_q ? delta_b[r0] : 0.f, r1 < s_q ? delta_b[r1] : 0.f};

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;

  for (int kv0 = 0; kv0 < s_kv; kv0 += kBK) {
    __syncthreads();
    stage_tile(ks, kts, k + kvoff, kv0, s_kv, n_cols, tid);
    stage_tile(vs, nullptr, v + kvoff, kv0, s_kv, n_cols, tid);
    __syncthreads();

    float p[8][4], dp[8][4];
    mma_regs_a(p, qa, ks, g, t);   // S = Q K^T
    mma_regs_a(dp, da, vs, g, t);  // dP = dO V^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kv0 + n * 8 + 2 * t + (j & 1);
        const float pv = key < s_kv ? exp2f(p[n][j] * scale_log2 - l2[j >> 1]) : 0.f;
        p[n][j] = pv * (dp[n][j] - dl[j >> 1]) * scale;  // dS
      }
    mma_packed_a<true>(acc, p, kts, g, t);  // dQ += dS K
  }
  store_rows(dq + qoff, acc, r0, s_q, n_cols, t);
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int s_q, int s_kv, int n_cols, float scale, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBQ * kLds];
  __shared__ __align__(16) __nv_bfloat16 qts[kD * kLds];
  __shared__ __align__(16) __nv_bfloat16 dos[kBQ * kLds];
  __shared__ __align__(16) __nv_bfloat16 dots[kD * kLds];
  __shared__ float l2s[kBQ];
  __shared__ float dls[kBQ];

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)h * kD;
  const size_t qoff = (size_t)b * s_q * n_cols + head;
  const size_t kvoff = (size_t)b * s_kv * n_cols + head;
  const float* lse_b = lse + ((size_t)b * gridDim.y + h) * s_q;
  const float* delta_b = delta + ((size_t)b * gridDim.y + h) * s_q;

  const int r0 = k0 + warp * 16 + g;
  uint32_t ka[4][4], va[4][4];
  load_a_rows(ka, k + kvoff, r0, s_kv, n_cols, t);
  load_a_rows(va, v + kvoff, r0, s_kv, n_cols, t);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[n][j] = dva[n][j] = 0.f;

  for (int q0 = 0; q0 < s_q; q0 += kBQ) {
    __syncthreads();
    stage_tile(qs, qts, q + qoff, q0, s_q, n_cols, tid);
    stage_tile(dos, dots, dout + qoff, q0, s_q, n_cols, tid);
    if (tid < kBQ) {
      const int row = q0 + tid;
      l2s[tid] = row < s_q ? lse_b[row] * 1.4426950408889634f : 0.f;
      dls[tid] = row < s_q ? delta_b[row] : 0.f;
    }
    __syncthreads();

    float p[8][4];
    mma_regs_a(p, ka, qs, g, t);  // S^T = K Q^T (16 keys x 64 queries)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n * 8 + 2 * t + (j & 1);
        p[n][j] = q0 + col < s_q ? exp2f(p[n][j] * scale_log2 - l2s[col]) : 0.f;
      }
    mma_packed_a<false>(dva, p, dots, g, t);  // dV += P^T dO

    float dp[8][4];
    mma_regs_a(dp, va, dos, g, t);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n * 8 + 2 * t + (j & 1);
        dp[n][j] = p[n][j] * (dp[n][j] - dls[col]) * scale;  // dS^T
      }
    mma_packed_a<true>(dka, dp, qts, g, t);  // dK += dS^T Q
  }
  store_rows(dk + kvoff, dka, r0, s_kv, n_cols, t);
  store_rows(dv + kvoff, dva, r0, s_kv, n_cols, t);
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

// dq like q; do like q; lse and delta f32 (b, heads, s_q).
extern "C" int svdx_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dq, int b, int s_q,
                                           int s_kv, int heads, float scale, void* stream) {
  const dim3 grid((s_q + kBQ - 1) / kBQ, heads, b);
  flash_bwd_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), s_q, s_kv, heads * kD, scale,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv like k, v.
extern "C" int svdx_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, int b,
                                            int s_q, int s_kv, int heads, float scale,
                                            void* stream) {
  const dim3 grid((s_kv + kBK - 1) / kBK, heads, b);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), s_q, s_kv,
      heads * kD, scale, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}
