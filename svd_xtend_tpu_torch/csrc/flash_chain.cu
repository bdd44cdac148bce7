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
// that stay on chip, and the steps are dependent, so the chain is bound by
// latency: one step's products, then (int8) the grid-wide maxima, then the
// next step. The design, for that:
//   - a cluster of `cluster` blocks (2-4) per 64 rows of q, split by keys:
//     block r of the cluster holds its 64-key blocks of K and V in shared
//     memory for all n steps, staged once at the start (nothing is re-staged
//     in the step loop), so the grid is (bq / 64) x cluster blocks, 40-80
//     SMs at the probe's tiles where the first design used 10-20;
//   - one warpgroup a block issues wgmma against its key slice: bf16 with q
//     and p as the register A operand (p re-packed from the score
//     accumulator), K K-major and V MN-major from 128-byte-swizzled tiles;
//     int8 (.s32.s8.s8) with qi and pi in swizzled tiles too (the integer
//     forms read both operands K-major, so K and V^T are staged transposed);
//   - each step the cluster sums its blocks' partial P V through distributed
//     shared memory, every block in rank order, so the blocks hold the same
//     next q; one cluster barrier a step (the partials double-buffered).
//     int32 sums are exact, so int8 is the same bits under any split; bf16's
//     f32 sums of the split are taken in another order than one block's;
//   - int8: two grid-wide barriers a step, each carrying a maximum (an
//     atomicMax, then a release add on a count of arrivals that every block
//     waits on; counters in a workspace per (device, stream), left at zero);
//     fewer cannot be: S_{i+1} needs sq_{i+1}, so every
//     row's O_i, and O_i needs sp_i, so every row's S_i: the 2n maxima of a
//     chain are a dependent sequence, each over the whole grid. The first
//     pass over the keys takes only max|S| in int32 (|f32(n) * sq * (1/bkm)|
//     rounded to nearest is monotone in |n| and odd, so max|p| is that of
//     max|S|, bit for bit), and a second pass recomputes S and quantises p
//     into the P V product, so p is never stored. The blocks must all be
//     resident: the host checks the active-cluster occupancy and refuses a
//     grid that does not fit rather than let the barrier wait for a block
//     that cannot start (that check stands in for a cooperative launch).
//   - K and V^T for int8, and K for bf16, are staged by plain 16-byte loads
//     and transposing shared-memory stores (TMA copies boxes, it does not
//     transpose); V for bf16 by 16-byte row copies. Once a launch.
//
// Exactness (int8): int32 sums and maxima are exact; x / s is IEEE division
// (__fdiv_rn); max / 127 is the product with the f32 reciprocal (XLA
// compiles a division by a constant so); rounding is half to even
// (__float2int_rn, as jnp.round); the int32 -> f32 conversions round to
// nearest; every f32 product is rounded in the order the JAX body writes it
// (__fmul_rn / __fadd_rn, never contracted). So the kernel equals its plain
// version bit for bit.
//
// Measured (chip_smoke.py and scripts/probe_int8_flash.py, NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md §6 row 15): the first design (bq/64 blocks of 4
// warps, mma.sync, K^T and V re-staged from L2 every step, int8 a
// cooperative launch with grid.sync()) took bf16 3.170 ms and int8_qd
// 7.609 ms at (1280, 1280), 60 steps; this one 0.30 and 1.55-1.59 ms
// there, and at (640, 640) / (1024, 1536) 0.27 / 0.31 and 1.17 / 1.56 ms
// (the parent's 1.56 / 3.60 and 4.14 / 8.93 in one call). A cluster of 2, 4
// or 8 blocks: bf16 fastest at 2-4 (8 blocks' partial sums cost more than
// they save), int8 at 8 (its step is the two grid barriers, and the key
// slices shrink). int8_qd / bf16 0.19-0.23x: the probe's rule (>= 1.5x)
// says no, and more firmly than on the first design (0.38-0.42x), since
// bf16 gained most from K and V staying resident.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {
namespace chain {

constexpr int kD = 64;            // head dim
constexpr int kRows = 64;         // rows of q per cluster
constexpr int kKeys = 64;         // keys per staged block
constexpr int kThreads = 128;     // one warpgroup
constexpr int kTile = 8192;       // a 64-row x 128-byte swizzled tile
constexpr int kMaxCluster = 8;
constexpr int kSmemCap = 232448;

// byte offset of (row, byte) in a 1024-aligned tile of 128-byte rows with
// TMA's 128-byte swizzle (sm90.cuh): chunk (byte / 16) ^ (row % 8)
__device__ __forceinline__ int sw(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t remote(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(sm90::smem_u32(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ float4 ld_remote_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ int4 ld_remote_i4(uint32_t a) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// d (64 x 64 s32) (+)= A (64 x 32 s8) . B (64 x 32 s8)^T, both K-major in
// shared memory
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,"
      "%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// this thread's accumulator entry i: row and column within the 64 x 64 tile
__device__ __forceinline__ int acc_row(int i, int tid) {
  return 16 * (tid / 32) + (tid % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i, int tid) {
  return 8 * (i / 4) + 2 * (tid % 4) + i % 2;
}

// The block's key blocks [j0, j1) of 64 keys: j0 = rank * nb / cluster.
struct Slice {
  int j0, kb;
};
__device__ __forceinline__ Slice slice_of(int bkm, int cluster, int rank) {
  const int nb = bkm / kKeys;
  const int j0 = rank * nb / cluster;
  return {j0, (rank + 1) * nb / cluster - j0};
}

// Stage key block j (keys key0..key0 + 63) of K^T (64, bkm) as a K-major
// tile (row = key, bytes = d * sizeof(T)): a thread reads 16 bytes of a
// K^T row (one d, several keys) and stores each element into its key's row.
template <typename T>
__device__ __forceinline__ void stage_k(char* tile, const T* kT, int key0, int bkm, int tid) {
  constexpr int kPer = 16 / sizeof(T);
  for (int i = tid; i < kD * kKeys / kPer; i += kThreads) {
    const int d = i / (kKeys / kPer), k0 = (i % (kKeys / kPer)) * kPer;
    const uint4 raw = *reinterpret_cast<const uint4*>(kT + (size_t)d * bkm + key0 + k0);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      *reinterpret_cast<T*>(tile + sw(k0 + j, d * (int)sizeof(T))) = e[j];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
chain_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kT,
                  const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int bkm,
                  int n_inner, int cluster, float inv_bkm) {
  extern __shared__ char smem_raw[];
  char* base = smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = static_cast<int>(cluster_rank()), tile_row = blockIdx.x / cluster;
  const Slice sl = slice_of(bkm, cluster, rank);
  const int kb_max = (bkm / kKeys + cluster - 1) / cluster;
  char* ktile = base;                    // kb K tiles (row = key, 128 bytes of d)
  char* vtile = base + kb_max * kTile;   // kb V tiles (row = key, 128 bytes of d)
  // the partials at the same offset in every block of the cluster
  float4* part = reinterpret_cast<float4*>(base + 2 * kb_max * kTile);
  for (int j = 0; j < sl.kb; ++j) {
    const int key0 = (sl.j0 + j) * kKeys;
    stage_k(ktile + j * kTile, kT, key0, bkm, tid);
    for (int i = tid; i < kKeys * 8; i += kThreads) {  // V rows: 128 bytes = 8 chunks
      const int r = i / 8, ch = i % 8;
      *reinterpret_cast<uint4*>(vtile + j * kTile + sw(r, ch * 16)) =
          *reinterpret_cast<const uint4*>(v + (size_t)(key0 + r) * kD + ch * 8);
    }
  }
  sm90::fence_proxy_async();
  __syncthreads();

  uint32_t qa[4][4];
  sm90::load_a_frags(qa, q, tile_row * kRows, 1 << 30, kD, warp, lane);
  float o[32];
  for (int it = 0; it < n_inner; ++it) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    for (int j = 0; j < sl.kb; ++j) {
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      const uint64_t kd = sm90::sw128_desc(ktile + j * kTile);
      const uint64_t vd = sm90::sw128_desc(vtile + j * kTile);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs<0>(s, qa[kk], sm90::kmajor_slice(kd, kk), kk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = sm90::pack_bf16(s[8 * kk + 2 * i] * inv_bkm, s[8 * kk + 2 * i + 1] * inv_bkm);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs<1>(o, pa[kk], sm90::mnmajor_slice(vd, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
    }
    // the cluster's sum of its partial P V, in rank order in every block
    float4* mine = part + (it & 1) * 8 * kThreads;
#pragma unroll
    for (int g = 0; g < 8; ++g)
      mine[g * kThreads + tid] = make_float4(o[4 * g], o[4 * g + 1], o[4 * g + 2], o[4 * g + 3]);
    cluster_sync();
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      float4 a = ld_remote_f4(remote(mine + g * kThreads + tid, 0));
      for (int r = 1; r < cluster; ++r) {
        const float4 b = ld_remote_f4(remote(mine + g * kThreads + tid, r));
        a = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
      }
      o[4 * g] = a.x;
      o[4 * g + 1] = a.y;
      o[4 * g + 2] = a.z;
      o[4 * g + 3] = a.w;
    }
    // q = bf16(O * 0.25) as the next step's A operand
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[kk][i] = sm90::pack_bf16(o[8 * kk + 2 * i] * 0.25f, o[8 * kk + 2 * i + 1] * 0.25f);
  }
  // out = f32(q): A fragment kk holds rows r0 (words 0, 2) and r0 + 8 (1, 3),
  // columns 16 kk + 2 (lane % 4) (words 0, 1) and + 8 (2, 3)
  if (rank == 0) {
    const int r0 = tile_row * kRows + 16 * warp + lane / 4;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][i]));
        *reinterpret_cast<float2*>(out + (size_t)(r0 + 8 * (i % 2)) * kD + 16 * kk +
                                   2 * (lane % 4) + 8 * (i / 2)) = f;
      }
  }
  cluster_sync();  // the others have read this block's partials
}

// ------------------------------------------------------------ int8 chain --

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The workspace's words, each on its own 128 bytes: the arrivals of the
// launch's barriers (round r waits for (r + 1) x grid), the blocks out, and
// three maxima slots (round r's is r % 3); all zero between launches.
constexpr int kArrive = 0, kExit = 32, kMax = 64;

// The maximum of `local` (an unsigned, uniform in the block) over every
// block of the grid at barrier round `round`: an atomicMax into its slot,
// then a release add on the arrivals and a wait for every block's. Block 0,
// past round r, clears round r - 1's slot: every block read it before it
// arrived at round r, and none writes it again before round r + 2, which it
// reaches only after block 0 arrived at round r + 1. A wait that never ends
// traps, so the launch fails instead of hanging the card.
__device__ unsigned grid_max(unsigned* ws, unsigned local, int round, unsigned* bcast) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* slot = ws + kMax + (round % 3) * 32;
    atomicMax(slot, local);
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(ws + kArrive) : "memory");
    const unsigned target = (round + 1) * gridDim.x;
    for (uint32_t polls = 0; ld_acquire(ws + kArrive) < target; ++polls) {
      __nanosleep(20);
      if (polls == (1u << 26)) __trap();
    }
    *bcast = ld_acquire(slot);
    if (blockIdx.x == 0 && round > 0)
      asm volatile("st.relaxed.gpu.global.u32 [%0], 0;\n" ::"l"(ws + kMax + ((round + 2) % 3) * 32)
                   : "memory");
  }
  __syncthreads();
  return *bcast;
}

// the block's largest of each thread's x (every thread gets it)
__device__ __forceinline__ unsigned block_max(unsigned x, unsigned* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  __syncthreads();  // `red` is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  return max(max(red[0], red[1]), max(red[2], red[3]));
}

// s = max * (1/127) + 1e-12: the JAX body divides by 127, which XLA compiles
// as the product with the f32 reciprocal
__device__ __forceinline__ float quant_scale(float mx) {
  return __fadd_rn(__fmul_rn(mx, 1.f / 127.f), 1e-12f);
}
__device__ __forceinline__ int8_t quant(float x, float s) {
  return static_cast<int8_t>(__float2int_rn(__fdiv_rn(x, s)));
}

// an entry pair (i, i + 1) of the accumulator layout into a K-major int8
// tile: two neighbouring bytes of one row
__device__ __forceinline__ void put_pair(char* tile, int i, int tid, int8_t a, int8_t b) {
  *reinterpret_cast<uint16_t*>(tile + sw(acc_row(i, tid), acc_col(i, tid))) =
      static_cast<uint16_t>(static_cast<uint8_t>(a) | (static_cast<uint8_t>(b) << 8));
}

__global__ void __launch_bounds__(kThreads, 1)
chain_int8_qd_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kT,
                     const int8_t* __restrict__ v, float* __restrict__ out, unsigned* ws,
                     int bkm, int n_inner, int cluster, float inv_bkm) {
  extern __shared__ char smem_raw[];
  char* base = smem_raw + ((1024u - (sm90::smem_u32(smem_raw) & 1023u)) & 1023u);
  __shared__ unsigned red[4], bcast;
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster_rank()), tile_row = blockIdx.x / cluster;
  const Slice sl = slice_of(bkm, cluster, rank);
  const int kb_max = (bkm / kKeys + cluster - 1) / cluster;
  char* ktile = base;                    // kb K tiles (row = key, 64 bytes of d)
  char* vtile = base + kb_max * kTile;   // kb V^T tiles (row = d, 64 bytes of keys)
  char* qi = base + 2 * kb_max * kTile;  // this step's qi (row = q row, 64 bytes of d)
  char* pi = qi + kTile;                 // a key block's pi (row = q row, 64 bytes of keys)
  int4* part = reinterpret_cast<int4*>(pi + kTile);
  for (int j = 0; j < sl.kb; ++j) {
    const int key0 = (sl.j0 + j) * kKeys;
    stage_k(ktile + j * kTile, kT, key0, bkm, tid);
    // V^T: a thread reads 16 d of one key's V row, stores each into its d's row
    for (int i = tid; i < kKeys * kD / 16; i += kThreads) {
      const int key = i / (kD / 16), d0 = (i % (kD / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(v + (size_t)(key0 + key) * kD + d0);
      const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j2 = 0; j2 < 16; ++j2) vtile[j * kTile + sw(d0 + j2, key)] = e[j2];
    }
  }

  float qf[32];
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        q + (size_t)(tile_row * kRows + acc_row(i, tid)) * kD + acc_col(i, tid)));
    qf[i] = f.x;
    qf[i + 1] = f.y;
  }
  const uint64_t qd = sm90::sw128_desc(qi), pd = sm90::sw128_desc(pi);
  for (int it = 0; it < n_inner; ++it) {
    // sq from max|q| over the grid (non-negative floats order as their bits)
    float mx = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) mx = fmaxf(mx, fabsf(qf[i]));
    const float sq = quant_scale(
        __uint_as_float(grid_max(ws, block_max(__float_as_uint(mx), red), 2 * it, &bcast)));
#pragma unroll
    for (int i = 0; i < 32; i += 2) put_pair(qi, i, tid, quant(qf[i], sq), quant(qf[i + 1], sq));
    sm90::fence_proxy_async();
    __syncthreads();

    // pass 1: max|S| over the block's keys, then over the grid
    unsigned smax = 0;
    for (int j = 0; j < sl.kb; ++j) {
      int32_t s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0;
      const uint64_t kd = sm90::sw128_desc(ktile + j * kTile);
      sm90::wgmma_fence();
      wgmma_s8(s, qd, kd, 0);
      wgmma_s8(s, sm90::kmajor_slice(qd, 1), sm90::kmajor_slice(kd, 1), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
#pragma unroll
      for (int i = 0; i < 32; ++i) smax = max(smax, static_cast<unsigned>(abs(s[i])));
    }
    const unsigned gs = grid_max(ws, block_max(smax, red), 2 * it + 1, &bcast);
    // max|p| = p(max|S|): the rounded products are odd and monotone in |S|
    const float sp = quant_scale(
        __fmul_rn(__fmul_rn(__int2float_rn(static_cast<int>(gs)), sq), inv_bkm));

    // pass 2: S again, p quantised into pi, O += pi V
    int32_t o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0;
    for (int j = 0; j < sl.kb; ++j) {
      int32_t s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0;
      const uint64_t kd = sm90::sw128_desc(ktile + j * kTile);
      const uint64_t vd = sm90::sw128_desc(vtile + j * kTile);
      sm90::wgmma_fence();
      wgmma_s8(s, qd, kd, 0);
      wgmma_s8(s, sm90::kmajor_slice(qd, 1), sm90::kmajor_slice(kd, 1), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      __syncthreads();  // the last block's P V has read pi
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float p0 = __fmul_rn(__fmul_rn(__int2float_rn(s[i]), sq), inv_bkm);
        const float p1 = __fmul_rn(__fmul_rn(__int2float_rn(s[i + 1]), sq), inv_bkm);
        put_pair(pi, i, tid, quant(p0, sp), quant(p1, sp));
      }
      sm90::fence_proxy_async();
      __syncthreads();
      sm90::wgmma_fence();
      wgmma_s8(o, pd, vd, 1);
      wgmma_s8(o, sm90::kmajor_slice(pd, 1), sm90::kmajor_slice(vd, 1), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
    }
    // the cluster's sum of its partial pi V (exact), then q = f32(O) * sp * 0.25
    int4* mine = part + (it & 1) * 8 * kThreads;
#pragma unroll
    for (int g = 0; g < 8; ++g)
      mine[g * kThreads + tid] = make_int4(o[4 * g], o[4 * g + 1], o[4 * g + 2], o[4 * g + 3]);
    cluster_sync();
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      int4 a = ld_remote_i4(remote(mine + g * kThreads + tid, 0));
      for (int r = 1; r < cluster; ++r) {
        const int4 b = ld_remote_i4(remote(mine + g * kThreads + tid, r));
        a = make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
      }
      const int e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        qf[4 * g + u] = __fmul_rn(__fmul_rn(__int2float_rn(e[u]), sp), 0.25f);
    }
  }
  if (rank == 0)
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<float2*>(out + (size_t)(tile_row * kRows + acc_row(i, tid)) * kD +
                                 acc_col(i, tid)) = make_float2(qf[i], qf[i + 1]);
  cluster_sync();  // the others have read this block's partials
  // the last block out resets the arrivals and the last round's slot (block
  // 0 cleared the others)
  if (tid == 0 && n_inner > 0) {
    unsigned left;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(left)
                 : "l"(ws + kExit)
                 : "memory");
    if (left == gridDim.x - 1) {
      ws[kArrive] = 0;
      ws[kMax + ((2 * n_inner - 1) % 3) * 32] = 0;
      ws[kExit] = 0;
    }
  }
}

// the dynamic shared memory of a block: its K and V tiles (bf16), or its K
// and V^T tiles, qi, pi (int8); the double-buffered 64 x 64 partials; 1 KB
// of alignment slack
inline int smem_bytes(int bkm, int cluster, bool int8) {
  const int kb_max = (bkm / kKeys + cluster - 1) / cluster;
  return 1024 + 2 * kb_max * kTile + (int8 ? 2 * kTile : 0) + 2 * kRows * kD * 4;
}

template <class Kernel, class... Args>
int launch(Kernel kernel, int bq, int bkm, int cluster, bool int8, bool resident,
           cudaStream_t stream, Args... args) {
  const int smem = smem_bytes(bkm, cluster, int8);
  if (bq < kRows || bq % kRows || bkm < kKeys || bkm % kKeys || cluster < 1 ||
      cluster > kMaxCluster || cluster > bkm / kKeys || smem > kSmemCap - 128)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((bq / kRows) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident) {  // the grid barrier needs every cluster on the card at once
    int fit = 0;
    err = static_cast<int>(cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg));
    if (err) return err;
    if (fit < bq / kRows) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  }
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chain
}  // namespace

// q: (bq, 64) bf16; kT: (64, bkm) bf16; v: (bkm, 64) bf16; out: (bq, 64)
// f32; bq and bkm multiples of 64; all contiguous and 16-byte aligned; a
// cluster of `cluster` blocks (at most 8, at most bkm / 64) per 64 rows.
// Returns the launch's error, or cudaErrorInvalidValue for a geometry it
// does not take.
extern "C" int svdx_chain_bf16(const void* q, const void* kT, const void* v, void* out, int bq,
                               int bkm, int n_inner, int cluster, float inv_bkm, void* stream) {
  return chain::launch(chain::chain_bf16_kernel, bq, bkm, cluster, false, false,
                       static_cast<cudaStream_t>(stream), static_cast<const __nv_bfloat16*>(q),
                       static_cast<const __nv_bfloat16*>(kT),
                       static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), bkm,
                       n_inner, cluster, inv_bkm);
}

// q: (bq, 64) bf16; kT: (64, bkm) int8; v: (bkm, 64) int8; out: (bq, 64)
// f32; ws: the stream's 160-word barrier workspace (zero, and left zero);
// the geometry as svdx_chain_bf16's. Every cluster must be resident at once
// (cudaErrorCooperativeLaunchTooLarge where they are not).
extern "C" int svdx_chain_int8_qd(const void* q, const void* kT, const void* v, void* out,
                                  void* ws, int bq, int bkm, int n_inner, int cluster,
                                  float inv_bkm, void* stream) {
  return chain::launch(chain::chain_int8_qd_kernel, bq, bkm, cluster, true, true,
                       static_cast<cudaStream_t>(stream), static_cast<const __nv_bfloat16*>(q),
                       static_cast<const int8_t*>(kT), static_cast<const int8_t*>(v),
                       static_cast<float*>(out), static_cast<unsigned*>(ws), bkm, n_inner,
                       cluster, inv_bkm);
}
