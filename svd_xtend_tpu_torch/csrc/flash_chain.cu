// The flash forward's dependent product chain, in bf16 and in int8 with
// dynamic quantisation: n_inner steps of scores = Q K^T, out = P V, each
// step's Q the last step's output.
//
// Replaces scripts/probe_int8_flash.py::_chain_bf16 and ::_chain_int8_qd
// (launched by its `run`): the TPU probe asking whether int8 QK^T / PV
// products would speed up the flash kernel. One (bq, 64) Q, K^T (64, bkm),
// V (bkm, 64), d = 64:
//   bf16:    p = bf16(Q K^T * (1/bkm)); q = bf16(P V * 0.25)       (f32 sums)
//   int8_qd: qi, sq = quant(q); p = f32(qi K^T) * sq * (1/bkm);
//            pi, sp = quant(p); q = f32(pi V) * sp * 0.25           (int32 sums)
//   quant(x) = round_half_even(x / s) as int8, s = max|x| / 127 + 1e-12,
//   the max over the WHOLE tensor.
//
// What bounds it on an H100: each step is 4*bq*64*bkm operations on inputs
// that stay on chip (K and V are at most 192 KB each, L2-resident), and the
// steps are dependent, so the chain is bound by latency: one step's
// products, then (int8) the grid-wide maxima, then the next step.
//
// bf16 chain: every row of q evolves on its own, so blocks need nothing from
// each other. One block = 4 warps = 64 rows; a warp keeps its 16 rows of q as
// mma A fragments in registers for all n_inner steps, walks K^T and V in
// 64-key chunks (staged transposed in shared memory), keeps p in registers
// (re-packed from the score accumulators as the A operand of P V), and
// re-packs bf16(out * 0.25) as the next step's A fragments.
//
// int8_qd chain: each step takes two maxima over the whole problem, over q
// (bq x 64) and over p (bq x bkm). On the TPU the chain sits in one kernel
// body with everything in VMEM; here the rows are spread over bq/64 blocks.
// Chosen: a cooperative launch (cudaLaunchCooperativeKernel) of bq/64 blocks,
// all resident at once (10-24 blocks on 132 SMs), with grid.sync() after each
// partial maximum. A thread-block cluster exchanging maxima through
// distributed shared memory would also do for bq <= 1024, but bq = 1280
// needs 20 blocks, past the portable cluster size of 8 (16 only as a
// non-portable opt-in), and a cluster's shared memory cannot hold p either.
// p (bq x bkm f32, <= 6.6 MB) goes to an L2-resident scratch that the
// wrapper allocates: it must exist whole before its maximum is known. Each
// warp re-reads only its own rows of it. Products on the tensor cores with
// mma.sync m16n8k32 s8 x s8 -> s32.
//
// Exactness: int32 sums and maxima are exact; x / s is IEEE division
// (__fdiv_rn); max / 127 is the product with the f32 reciprocal (XLA
// compiles a division by a constant so); rounding is half to even
// (__float2int_rn, as jnp.round); the int32 -> f32 conversions round to
// nearest; every f32 product is rounded in the order the JAX body writes it
// (__fmul_rn / __fadd_rn, never contracted). So the kernel equals its plain
// version bit for bit.
//
// Not yet done (later work): cp.async staging, one grid barrier per step
// (the p maximum can be formed from the int32 sums' maximum), ldmatrix.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kD = 64;          // head dim
constexpr int kRows = 64;       // rows of q per block
constexpr int kChunk = 64;      // keys per staged chunk
constexpr int kLds = kD + 8;    // bf16 row stride in shared memory
constexpr int kLd8 = kD + 16;   // int8 row stride in bytes (conflict-free 32-bit loads)
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
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

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments (16 x 64, four k16 steps) from C fragments (eight n8 tiles).
__device__ __forceinline__ void repack_a(uint32_t (&a)[4][4], const float (&c)[8][4],
                                         float mul) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0] * mul, c[2 * kk][1] * mul);
    a[kk][1] = pack_bf16(c[2 * kk][2] * mul, c[2 * kk][3] * mul);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0] * mul, c[2 * kk + 1][1] * mul);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2] * mul, c[2 * kk + 1][3] * mul);
  }
}

// Stage the chunk of keys [key0, key0 + 64) of K^T (64 x bkm) key-major into
// kt[key][d], and of V (bkm x 64) transposed into vt[d][key]. T is bf16 or
// int8; ld is the row stride in elements.
template <typename T, int kLd>
__device__ __forceinline__ void stage_chunk(T* kt, T* vt, const T* kT, const T* v, int key0,
                                            int bkm, int tid) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte load
  for (int i = tid; i < kD * kChunk / kPer; i += kThreads) {
    const int row = i / (kChunk / kPer), col = (i % (kChunk / kPer)) * kPer;
    const uint4 kv = *reinterpret_cast<const uint4*>(kT + (size_t)row * bkm + key0 + col);
    const uint4 vv = *reinterpret_cast<const uint4*>(v + (size_t)(key0 + row) * kD + col);
    const T* ke = reinterpret_cast<const T*>(&kv);
    const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      kt[(col + j) * kLd + row] = ke[j];  // K^T[d = row][key = col + j]
      vt[(col + j) * kLd + row] = ve[j];  // V[key = row][d = col + j]
    }
  }
}

__global__ void __launch_bounds__(kThreads)
chain_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kT,
                  const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int bkm,
                  int n_inner, float inv_bkm) {
  __shared__ __align__(16) __nv_bfloat16 kt[kChunk * kLds];
  __shared__ __align__(16) __nv_bfloat16 vt[kD * kLds];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows + warp * 16 + g, r1 = r0 + 8;

  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld32(q + (size_t)r0 * kD + c);
    qa[kk][1] = ld32(q + (size_t)r1 * kD + c);
    qa[kk][2] = ld32(q + (size_t)r0 * kD + c + 8);
    qa[kk][3] = ld32(q + (size_t)r1 * kD + c + 8);
  }
  float acc[8][4];
  for (int it = 0; it < n_inner; ++it) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
    for (int key0 = 0; key0 < bkm; key0 += kChunk) {
      __syncthreads();
      stage_chunk<__nv_bfloat16, kLds>(kt, vt, kT, v, key0, bkm, tid);
      __syncthreads();
      float s[8][4];  // 16 rows x 64 keys
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const __nv_bfloat16* kp = kt + (n * 8 + g) * kLds + kk * 16 + 2 * t;
          mma_bf16(s[n], qa[kk], ld32(kp), ld32(kp + 8));
        }
      }
      uint32_t pa[4][4];
      repack_a(pa, s, inv_bkm);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const __nv_bfloat16* vp = vt + (n * 8 + g) * kLds + kk * 16 + 2 * t;
          mma_bf16(acc[n], pa[kk], ld32(vp), ld32(vp + 8));
        }
    }
    repack_a(qa, acc, 0.25f);
  }
  // out = f32(q): the bf16 values of the last step
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * t;
    const uint32_t w[4] = {qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3]};
    const int rows[4] = {r0, r1, r0, r1}, cols[4] = {c, c, c + 8, c + 8};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      *reinterpret_cast<float2*>(out + (size_t)rows[i] * kD + cols[i]) = f;
    }
  }
}

// max over the block of each thread's `x`; every thread gets the result
__device__ __forceinline__ float block_max(float x, float* red, int tid) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();  // `red` is free
  if ((tid & 31) == 0) red[tid >> 5] = x;
  __syncthreads();
  return fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
}

// s = max over the blocks' partial maxima * (1/127) + 1e-12: the JAX body
// divides by 127, which XLA compiles as the product with the f32 reciprocal
__device__ __forceinline__ float grid_scale(const float* partial, int n) {
  float mx = partial[0];
  for (int i = 1; i < n; ++i) mx = fmaxf(mx, partial[i]);
  return __fadd_rn(__fmul_rn(mx, 1.f / 127.f), 1e-12f);
}

__device__ __forceinline__ uint32_t quant4(float a, float b, float c, float d, float s) {
  const uint32_t q0 = (uint8_t)(int8_t)__float2int_rn(__fdiv_rn(a, s));
  const uint32_t q1 = (uint8_t)(int8_t)__float2int_rn(__fdiv_rn(b, s));
  const uint32_t q2 = (uint8_t)(int8_t)__float2int_rn(__fdiv_rn(c, s));
  const uint32_t q3 = (uint8_t)(int8_t)__float2int_rn(__fdiv_rn(d, s));
  return q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
}

__global__ void __launch_bounds__(kThreads)
chain_int8_qd_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kT,
                     const int8_t* __restrict__ v, float* __restrict__ out,
                     float* p_scratch, float* partial_q, float* partial_p, int bkm,
                     int n_inner, float inv_bkm) {
  // the scratch pointers are written by one block and read by others
  // across grid.sync(), so none of them is __restrict__
  __shared__ __align__(16) int8_t kt[kChunk * kLd8];
  __shared__ __align__(16) int8_t vt[kD * kLd8];
  __shared__ __align__(16) int8_t qs[kRows * kLd8];
  __shared__ float red[4];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // rows within the block
  const int r0 = blockIdx.x * kRows + lr0, r1 = r0 + 8;
  float* p0 = p_scratch + (size_t)r0 * bkm;
  float* p1 = p_scratch + (size_t)r1 * bkm;

  // q in C-fragment layout: rows r0 (j = 0, 1) and r1 (j = 2, 3), columns n*8 + 2t + (j & 1)
  float qf[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + (size_t)r0 * kD + c));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q + (size_t)r1 * kD + c));
    qf[n][0] = a.x;
    qf[n][1] = a.y;
    qf[n][2] = b.x;
    qf[n][3] = b.y;
  }

  for (int it = 0; it < n_inner; ++it) {
    // sq from the maximum of |q| over the grid
    float mx = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, fabsf(qf[n][j]));
    mx = block_max(mx, red, tid);
    if (tid == 0) partial_q[blockIdx.x] = mx;
    grid.sync();
    const float sq = grid_scale(partial_q, gridDim.x);

    // qi into shared memory (the warp's own rows), then as A fragments
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t;
      qs[lr0 * kLd8 + c] = (int8_t)__float2int_rn(__fdiv_rn(qf[n][0], sq));
      qs[lr0 * kLd8 + c + 1] = (int8_t)__float2int_rn(__fdiv_rn(qf[n][1], sq));
      qs[lr1 * kLd8 + c] = (int8_t)__float2int_rn(__fdiv_rn(qf[n][2], sq));
      qs[lr1 * kLd8 + c + 1] = (int8_t)__float2int_rn(__fdiv_rn(qf[n][3], sq));
    }
    __syncwarp();
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int c = kk * 32 + 4 * t;
      qa[kk][0] = ld32(qs + lr0 * kLd8 + c);
      qa[kk][1] = ld32(qs + lr1 * kLd8 + c);
      qa[kk][2] = ld32(qs + lr0 * kLd8 + c + 16);
      qa[kk][3] = ld32(qs + lr1 * kLd8 + c + 16);
    }

    // p = f32(qi K^T) * sq * (1/bkm) into the scratch; its maximum |p|
    float pmx = 0.f;
    for (int key0 = 0; key0 < bkm; key0 += kChunk) {
      __syncthreads();
      stage_chunk<int8_t, kLd8>(kt, vt, kT, v, key0, bkm, tid);
      __syncthreads();
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        int c[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int8_t* kp = kt + (n * 8 + g) * kLd8 + kk * 32 + 4 * t;
          mma_s8(c, qa[kk], ld32(kp), ld32(kp + 16));
        }
        float p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = __fmul_rn(__fmul_rn(__int2float_rn(c[j]), sq), inv_bkm);
          pmx = fmaxf(pmx, fabsf(p[j]));
        }
        const int col = key0 + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(p0 + col) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(p1 + col) = make_float2(p[2], p[3]);
      }
    }
    pmx = block_max(pmx, red, tid);
    if (tid == 0) partial_p[blockIdx.x] = pmx;
    grid.sync();  // also orders this warp's scratch writes before its reads
    const float sp = grid_scale(partial_p, gridDim.x);

    // o = f32(pi V) * sp; q = o * 0.25
    int acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] = 0;
    for (int key0 = 0; key0 < bkm; key0 += kChunk) {
      __syncthreads();
      stage_chunk<int8_t, kLd8>(kt, vt, kT, v, key0, bkm, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int c = key0 + kk * 32 + 4 * t;
        const float4 a0 = *reinterpret_cast<const float4*>(p0 + c);
        const float4 a1 = *reinterpret_cast<const float4*>(p1 + c);
        const float4 a2 = *reinterpret_cast<const float4*>(p0 + c + 16);
        const float4 a3 = *reinterpret_cast<const float4*>(p1 + c + 16);
        const uint32_t pa[4] = {quant4(a0.x, a0.y, a0.z, a0.w, sp),
                                quant4(a1.x, a1.y, a1.z, a1.w, sp),
                                quant4(a2.x, a2.y, a2.z, a2.w, sp),
                                quant4(a3.x, a3.y, a3.z, a3.w, sp)};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int8_t* vp = vt + (n * 8 + g) * kLd8 + kk * 32 + 4 * t;
          mma_s8(acc[n], pa, ld32(vp), ld32(vp + 16));
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        qf[n][j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[n][j]), sp), 0.25f);
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + (size_t)r0 * kD + c) = make_float2(qf[n][0], qf[n][1]);
    *reinterpret_cast<float2*>(out + (size_t)r1 * kD + c) = make_float2(qf[n][2], qf[n][3]);
  }
}

}  // namespace

// q: (bq, 64) bf16; kT: (64, bkm) bf16; v: (bkm, 64) bf16; out: (bq, 64)
// f32; bq and bkm multiples of 64; all contiguous and 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int svdx_chain_bf16(const void* q, const void* kT, const void* v, void* out, int bq,
                               int bkm, int n_inner, float inv_bkm, void* stream) {
  chain_bf16_kernel<<<bq / kRows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kT),
      static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), bkm, n_inner, inv_bkm);
  return static_cast<int>(cudaGetLastError());
}

// q: (bq, 64) bf16; kT: (64, bkm) int8; v: (bkm, 64) int8; out: (bq, 64)
// f32; p_scratch: (bq, bkm) f32; partial_q, partial_p: bq / 64 floats each.
// A cooperative launch of bq / 64 blocks: its error (e.g. more blocks than
// can be resident at once) is returned.
extern "C" int svdx_chain_int8_qd(const void* q, const void* kT, const void* v, void* out,
                                  void* p_scratch, void* partial_q, void* partial_p, int bq,
                                  int bkm, int n_inner, float inv_bkm, void* stream) {
  const void* qp = q;
  const void* kp = kT;
  const void* vp = v;
  void* op = out;
  void* sp = p_scratch;
  void* pq = partial_q;
  void* pp = partial_p;
  void* args[] = {&qp, &kp, &vp, &op, &sp, &pq, &pp, &bkm, &n_inner, &inv_bkm};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(chain_int8_qd_kernel), dim3(bq / kRows), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
