// GroupNorm (+ SiLU) over channels-last (N, rows, C) tensors in bf16, fp16
// or f32, for Hopper (sm_90a): y = [silu](((x - mean) * rstd) * scale + bias)
// with mean and rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps) per (sample,
// group), the TPU kernel's formula (svd_xtend_tpu/ops/pallas/groupnorm.py:
// 60-64).
//
// Replaces svd_xtend_tpu/ops/pallas/groupnorm.py::_gn_silu_kernel (one
// sample resident in VMEM: read once, statistics, normalise, write once) and
// its tiled pair _stats_kernel / _norm_kernel, for samples VMEM does not
// hold.
//
// What bounds it on an H100: no products, so device-memory bytes; the least
// traffic reads x once and writes y once (0.027 ms at the UNet's (28, 2560,
// 320)). A two-pass kernel reads x twice (3 bytes of traffic an element
// against the bound's 2). Two paths, chosen by ops/kernels/groupnorm.py's
// group_norm_plan from the sample's size against the cluster's shared memory:
//
// (a) cluster_kernel, sample-resident, the counterpart of _gn_silu_kernel:
//   - one cluster of kCtas = 8 CTAs (the portable size) per sample; CTA j
//     holds rows [j R, (j + 1) R) of it, R = ceil(rows / 8), in shared
//     memory: 8 x 227 KB hold a (2560, 320) bf16 UNet sample (1.64 MB),
//     the card's answer to VMEM residency;
//   - the rows come by bulk copy (TMA, one contiguous range a piece) in
//     kPieces pieces on their own mbarriers, so the statistics start on the
//     first piece while the others load;
//   - each thread sums 16 bytes of channels over every phases-th row in
//     row order; the per-channel sums go through shared memory into f32
//     group sums and sums of squares in a fixed order;
//   - after a cluster barrier every CTA reads the 8 CTAs' group partials
//     through distributed shared memory, in rank order, so every CTA gets
//     the same bits;
//   - it normalises its rows in place, applies the affine (+ SiLU, by the
//     fast __expf and __fdividef: with IEEE expf and division the SiLU's
//     arithmetic, not the bytes, set the kernel's time; their f32 error is
//     far below the output's bf16) and
//     stores them piece by piece by bulk copy, each piece's store running
//     under the next piece's arithmetic; a last cluster barrier keeps its
//     partials alive until the others have read them.
//   x is read once and y written once, the bound's own traffic. Cost: one
//   CTA an SM at the UNet's L0 (200 KB of rows), and a cluster needs 8 SMs
//   of one GPC, so 16 clusters at most run at once: the 28 samples of a CFG
//   pass take two waves, and in each the memory idles while the CTAs take
//   the last piece's sums, meet at the cluster barrier and normalise their
//   first piece. Measured (chip_smoke.py, H100 80GB HBM3, 700 W): 0.047 ms
//   at (28, 40, 64, 320) against the bound's 0.027; 384 threads a CTA or 8
//   pieces measured no faster (scripts/bench_frame_gn.py on edited copies).
//
// (b) the two-pass path, the counterpart of _stats_kernel / _norm_kernel, for
//   samples the cluster does not hold (the VAE decoder's (8, 163840, 128),
//   42 MB a sample, and its (2560, 512) mid-block, 2.6 MB): the statistics
//   as per-(sample, 64-row chunk, channel) partials read in full, coalesced
//   rows (csrc/gn_stats.cuh), their fold into (sc, sh) (gn_stats::fold), and
//   one elementwise pass x * sc + sh (+ SiLU) (csrc/affine_silu.cuh).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "affine_silu.cuh"
#include "gn_stats.cuh"
#include "sm90.cuh"

namespace {
namespace gn_cluster {

constexpr int kCtas = 8;        // CTAs a cluster = a sample
constexpr int kThreads = 256;
constexpr int kPieces = 4;      // bulk copies (and stores) a CTA's rows are cut into
constexpr int kMaxGroups = 64;
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int vec(int elem) { return 16 / elem; }

// The layout of a CTA's dynamic shared memory (ops/kernels/groupnorm.py's
// cluster_smem mirrors it): its rows; the per-(row phase, channel) sums and
// sums of squares; its group partials (sum, sum of squares); the sample's
// group statistics (mean, rstd); the pieces' mbarriers.
struct Layout {
  int data, phases, scratch, part, stat, bars, total;
  __host__ __device__ Layout(int rows_per_cta, int c, int elem) {
    phases = kThreads / (c / vec(elem));
    data = (rows_per_cta * c * elem + 15) / 16 * 16;
    scratch = data;
    part = scratch + 2 * phases * c * 4;
    stat = part + 2 * kMaxGroups * 4;
    bars = stat + 2 * kMaxGroups * 4;
    total = bars + kPieces * 8;
  }
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(sm90::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(sm90::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(sm90::smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the f32 at `p` in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(sm90::smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[vec(sizeof(T))]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < vec(sizeof(T)); ++j) v[j] = affine_silu::to_f32(e[j]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[vec(sizeof(T))]) {
  __align__(16) T o[vec(sizeof(T))];
#pragma unroll
  for (int j = 0; j < vec(sizeof(T)); ++j) o[j] = affine_silu::from_f32<T>(v[j]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(o);
}

// One cluster per sample (blockIdx.x / kCtas), CTA rank blockIdx.x % kCtas;
// x, y (n, rows, c) contiguous, 16-byte aligned; scale, bias (c) f32.
template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreads, 1)
cluster_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ scale,
               const float* __restrict__ bias, int rows, int c, int groups, int rows_per_cta,
               float eps) {
  constexpr int kVec = vec(sizeof(T));
  extern __shared__ __align__(128) char raw[];
  const Layout lay(rows_per_cta, c, sizeof(T));
  T* data = reinterpret_cast<T*>(raw);
  float* scr_s = reinterpret_cast<float*>(raw + lay.scratch);
  float* scr_q = scr_s + lay.phases * c;
  float* part = reinterpret_cast<float*>(raw + lay.part);   // [sum | sum of squares][group]
  float* stat = reinterpret_cast<float*>(raw + lay.stat);   // [mean | rstd][group]
  uint64_t* bars = reinterpret_cast<uint64_t*>(raw + lay.bars);

  const int t = threadIdx.x;
  const int rank = blockIdx.x % kCtas, n = blockIdx.x / kCtas;
  const int r0 = rank * rows_per_cta;
  const int my_rows = max(0, min(rows_per_cta, rows - r0));
  const int piece_rows = (rows_per_cta + kPieces - 1) / kPieces;
  const size_t first = ((size_t)n * rows + r0) * c;  // this CTA's first element

  if (t == 0) {
    for (int p = 0; p < kPieces; ++p) sm90::mbar_init(&bars[p], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (t == 0)
    for (int p = 0; p < kPieces; ++p) {
      const int a = p * piece_rows, e = min(my_rows, a + piece_rows);
      if (a >= e) break;
      const uint32_t bytes = (uint32_t)(e - a) * c * sizeof(T);
      sm90::mbar_arrive_expect_tx(&bars[p], bytes);
      bulk_load(data + (size_t)a * c, x + first + (size_t)a * c, bytes, &bars[p]);
    }

  // per-channel sums of this thread's 16 bytes of channels (cs) over the
  // rows rp, rp + phases, ..., in row order, each piece once it has landed
  const int ncs = c / kVec, phases = lay.phases;
  const bool active = t < phases * ncs;
  const int cs = t % ncs, rp = t / ncs;
  // this thread's first row at or after row a
  auto first_row = [&](int a) { return a + ((rp - a) % phases + phases) % phases; };
  if (active) {
    float s[kVec], q[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) s[j] = q[j] = 0.f;
    for (int p = 0; p < kPieces; ++p) {
      const int a = p * piece_rows, e = min(my_rows, a + piece_rows);
      if (a >= e) break;
      sm90::mbar_wait(&bars[p], 0);
#pragma unroll 4
      for (int r = first_row(a); r < e; r += phases) {
        float v[kVec];
        load_vec(data + (size_t)r * c + cs * kVec, v);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          s[j] += v[j];
          q[j] = fmaf(v[j], v[j], q[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      scr_s[rp * c + cs * kVec + j] = s[j];
      scr_q[rp * c + cs * kVec + j] = q[j];
    }
  }
  __syncthreads();
  // channel sums over the row phases, then group sums over the channels:
  // fixed orders
  for (int ch = t; ch < c; ch += kThreads) {
    float a = 0.f, b = 0.f;
    for (int ph = 0; ph < phases; ++ph) {
      a += scr_s[ph * c + ch];
      b += scr_q[ph * c + ch];
    }
    scr_s[ch] = a;
    scr_q[ch] = b;
  }
  __syncthreads();
  const int gs = c / groups;
  for (int g = t; g < groups; g += kThreads) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < gs; ++j) {
      a += scr_s[g * gs + j];
      b += scr_q[g * gs + j];
    }
    part[g] = a;
    part[kMaxGroups + g] = b;
  }
  cluster_arrive();  // every CTA's partials are written ...
  cluster_wait();    // ... and visible
  const float count = static_cast<float>((double)rows * gs);
  for (int g = t; g < groups; g += kThreads) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < kCtas; ++j) {
      a += ld_cluster(&part[g], j);
      b += ld_cluster(&part[kMaxGroups + g], j);
    }
    const float mean = a / count;
    stat[g] = mean;
    stat[kMaxGroups + g] = rsqrtf(fmaxf(b / count - mean * mean, 0.f) + eps);
  }
  cluster_arrive();  // this CTA has read the others' partials
  __syncthreads();

  float mu[kVec], rs[kVec], w[kVec], bb[kVec];
  if (active)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int ch = cs * kVec + j, g = ch / gs;
      mu[j] = stat[g];
      rs[j] = stat[kMaxGroups + g];
      w[j] = scale[ch];
      bb[j] = bias[ch];
    }
  for (int p = 0; p < kPieces; ++p) {
    const int a = p * piece_rows, e = min(my_rows, a + piece_rows);
    if (a >= e) break;
    if (active)
#pragma unroll 4
      for (int r = first_row(a); r < e; r += phases) {
        T* row = data + (size_t)r * c + cs * kVec;
        float v[kVec];
        load_vec(row, v);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          float o = __fmul_rn(__fsub_rn(v[j], mu[j]), rs[j]);
          o = __fadd_rn(__fmul_rn(o, w[j]), bb[j]);
          if (kSilu) o = __fdividef(o, 1.f + __expf(-o));
          v[j] = o;
        }
        store_vec(row, v);
      }
    sm90::fence_proxy_async();  // the piece's writes -> visible to the bulk store
    __syncthreads();
    if (t == 0)
      bulk_store(y + first + (size_t)a * c, data + (size_t)a * c,
                 (uint32_t)(e - a) * c * sizeof(T));
  }
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  cluster_wait();  // the others have read this CTA's partials
}

// the shared memory a block of cluster_kernel<T, kSilu> may take, set once
template <typename T, bool kSilu>
int allow_smem() {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      cluster_kernel<T, kSilu>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit));
  return err;
}

template <typename T>
int launch(const void* x, void* y, const void* scale, const void* bias, int n, int rows, int c,
           int groups, int rows_per_cta, float eps, bool silu, cudaStream_t stream) {
  const Layout lay(rows_per_cta, c, sizeof(T));
  if (c % vec(sizeof(T)) || c / vec(sizeof(T)) > kThreads || groups > kMaxGroups ||
      rows_per_cta < 1 || (long long)rows_per_cta * kCtas < rows ||
      (long long)n * kCtas > 0x7fffffffLL || lay.total > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = silu ? cluster_kernel<T, true> : cluster_kernel<T, false>;
  int err = silu ? allow_smem<T, true>() : allow_smem<T, false>();
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * kCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                                            static_cast<T*>(y), static_cast<const float*>(scale),
                                            static_cast<const float*>(bias), rows, c, groups,
                                            rows_per_cta, eps));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gn_cluster

// the two-pass path in element type T (see the top of the file)
template <typename T>
int two_pass(const void* x, void* y, const void* scale, const void* bias, void* psum, void* psq,
             void* sc, void* sh, int n, int rows, int c, int groups, float eps, bool silu,
             cudaStream_t s) {
  if (c % (16 / (int)sizeof(T))) return static_cast<int>(cudaErrorInvalidValue);
  const gn_stats::Stats st{static_cast<float*>(psum), static_cast<float*>(psq), c, rows,
                           gn_stats::slots(rows)};
  int err = gn_stats::launch<T>(x, st, n * rows, s);
  if (err == 0) err = gn_stats::fold(st, n, groups, scale, bias, sc, sh, eps, s);
  if (err == 0) err = affine_silu::launch<T>(x, sc, sh, y, (long long)n * rows, c, rows, silu, s);
  return err;
}

}  // namespace

// group_norm_silu on x, y (n, rows, c) of dtype 0 = bf16, 1 = fp16, 2 = f32,
// contiguous and 16-byte aligned, scale / bias (c) f32, by the path
// ops/kernels/groupnorm.py's group_norm_plan chose: rows_per_cta > 0 the
// sample-resident cluster kernel with that many rows a CTA (psum, psq, sc,
// sh unused), 0 the two-pass path with the partials psum / psq (n,
// gn_stats::slots(rows), c) f32 and sc / sh (n, c) f32 as scratch. Returns
// the first CUDA error of the launches (a cluster launch the card refuses
// included), or cudaErrorInvalidValue for a geometry the path does not take.
extern "C" int svdx_group_norm_silu(const void* x, void* y, const void* scale, const void* bias,
                                    void* psum, void* psq, void* sc, void* sh, int n, int rows,
                                    int c, int groups, int rows_per_cta, int dtype, int silu,
                                    float eps, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || rows < 1 || c < 2 || groups < 1 || c % groups || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows_per_cta > 0) {
    if (dtype == 0)
      return gn_cluster::launch<__nv_bfloat16>(x, y, scale, bias, n, rows, c, groups,
                                               rows_per_cta, eps, silu != 0, s);
    if (dtype == 1)
      return gn_cluster::launch<__half>(x, y, scale, bias, n, rows, c, groups, rows_per_cta,
                                        eps, silu != 0, s);
    return gn_cluster::launch<float>(x, y, scale, bias, n, rows, c, groups, rows_per_cta, eps,
                                     silu != 0, s);
  }
  if (dtype == 0)
    return two_pass<__nv_bfloat16>(x, y, scale, bias, psum, psq, sc, sh, n, rows, c, groups,
                                   eps, silu != 0, s);
  if (dtype == 1)
    return two_pass<__half>(x, y, scale, bias, psum, psq, sc, sh, n, rows, c, groups, eps,
                            silu != 0, s);
  return two_pass<float>(x, y, scale, bias, psum, psq, sc, sh, n, rows, c, groups, eps,
                         silu != 0, s);
}
