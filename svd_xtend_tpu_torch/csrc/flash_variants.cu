// The flash-attention forward in four softmax organisations, on the
// head-major (B*H, S, 64) bf16 layout, output only, for Hopper (sm_90a).
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
// What bounds it on an H100: as the packed forward (flash_attention.cu),
// 4*S*S*64 FLOPs per (batch*head) against 4*S*64*2 bytes: the tensor cores,
// with the softmax's MUFU and f32 work right behind them.
//
// Design: the packed forward's mainloop (csrc/flash_fwd.cuh: persistent
// blocks of 128 query rows in two consumer warpgroups, a producer warpgroup
// keeping a 3-stage TMA ring of K and V and two Q slots, wgmma for both
// products with Q from shared memory, P in registers and V read MN-major),
// with one softmax policy per mode. The tensor maps see the layout as (64
// columns, S rows, B*H samples). Each unit's steps run in turn (wait for
// S, softmax, then P V): with the packed forward's overlap of one unit's
// softmax and the last one's P V, major and major_exp2 ran 0.848 / 0.686
// ms against 0.796 / 0.661, base 0.890 against 0.893, nosoftmax 0.364
// against 0.386 (NVIDIA H100 80GB HBM3, 700.00 W, (140, 2560), device time
// in a CUDA graph, the timer that became scripts/bench_flash_forward.py), so
// all four modes keep one schedule and differ only in their softmax. The card's sub-tile is one wgmma's
// N, 64 keys, and its major tile one ring stage, 128 keys (the TPU's 512
// would be 256 score registers a thread): `base` takes its statistics per
// 64-key sub-tile, the other three per 128-key stage, so `major` does one
// statistics pass where `base` does two. S must be a multiple of 128 (the
// TPU probe's _choose_block refuses the rest); the wrapper checks it.
//
// exp versus exp2: `base` and `major` call the accurate expf (jnp.exp's
// arithmetic: a range reduction around one MUFU.EX2), `major_exp2` calls
// exp2f (MUFU.EX2 with log2(e) already in the scale), `nosoftmax` none.
// __expf or ex2.approx in base or major would make them the same
// instructions as major_exp2 and the probe's question moot.

#include "flash_fwd.cuh"

namespace {

using namespace flash_fwd;

enum Mode { kBase = 0, kMajor = 1, kMajorExp2 = 2, kNoSoftmax = 3 };

template <int kMode>
struct PolicyOf {
  using type = OnlineVariant<kMode == kBase ? 1 : 2, kMode == kMajorExp2>;
};
template <>
struct PolicyOf<kNoSoftmax> {
  using type = NoSoftmax;
};

// A persistent block over the (128-query tile, batch*head) items: the
// tensor maps see (64 columns, S rows, B*H samples), so an item's head is
// always 0 and its sample the batch*head index.
using Block = Smem<2>;

template <int kMode>
__global__ void __launch_bounds__(Block::kThreads, Block::kBlocksPerSm)
flash_variant_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     __nv_bfloat16* __restrict__ o, int bh, int s_q, int s_kv,
                     float scale) {
  extern __shared__ char smem_raw[];
  Block& sm = sm90::aligned_smem<Block>(smem_raw);
  const int n_qt = s_q / Block::kRows, n_items = n_qt * bh, n_stages = s_kv / kStageKeys;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  init_barriers(sm);

  if (wg == 2) {  // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x % 128 == 0)
      produce(sm, &q_map, &k_map, &v_map, n_items, n_qt, 1, n_stages);
  } else {  // consumers
    sm90::setmaxnreg_inc<Block::kConsumerRegs>();
    int it0 = 0;
    for (int w = blockIdx.x, ii = 0; w < n_items; w += gridDim.x, ++ii, it0 += n_stages) {
      const Item item = item_of(w, n_qt, 1);
      const int row0 = item.qt * Block::kRows + wg * 64;
      const size_t qoff = (size_t)item.b * s_q * kD;
      const uint64_t qd = wait_q(sm, ii, wg);
      typename PolicyOf<kMode>::type pol(scale);
      float acc[32];
      consume<false>(sm, qd, acc, pol, s_kv, lane, it0);
      free_q(sm, ii, lane);

      float inv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float l = quad_sum(pol.l[j]);
        inv[j] = 1.f / (l == 0.f ? 1.f : l);
      }
      store_rows(o + qoff, acc, inv, row0 + 16 * warp + (lane >> 2), s_q, kD, lane & 3);
    }
  }
}

template <int kMode>
int launch(const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map,
           void* o, int bh, int s_q, int s_kv, float scale, cudaStream_t stream) {
  constexpr int smem = sm90::smem_bytes<Block>();
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      flash_variant_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (attr != 0) return attr;
  flash_variant_kernel<kMode><<<persistent_blocks(s_q / Block::kRows * bh, 1),
                                Block::kThreads, smem, stream>>>(q_map, k_map, v_map,
                                          static_cast<__nv_bfloat16*>(o), bh, s_q, s_kv,
                                          scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (bh, s_q, 64), k/v: (bh, s_kv, 64), o like q; bf16, contiguous,
// 16-byte aligned; s_q and s_kv multiples of 128; mode 0-3 as Mode.
// Returns cudaErrorInvalidValue without launching for an unknown mode or a
// geometry the tensor-map encoder refuses, else cudaGetLastError() after
// the launch.
extern "C" int svdx_flash_variant_fwd(const void* q, const void* k, const void* v, void* o,
                                      int bh, int s_q, int s_kv, float scale, int mode,
                                      void* stream) {
  if (mode < kBase || mode > kNoSoftmax) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  int err = sm90::encode_rows_map(&q_map, q, kD, s_q, bh, Block::kRows);
  if (err == 0) err = sm90::encode_rows_map(&k_map, k, kD, s_kv, bh, kStageKeys);
  if (err == 0) err = sm90::encode_rows_map(&v_map, v, kD, s_kv, bh, kStageKeys);
  if (err != 0) return err;
  const float sc = mode == kMajorExp2 ? scale * kLog2e : scale;
  auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kBase:
      return launch<kBase>(q_map, k_map, v_map, o, bh, s_q, s_kv, sc, st);
    case kMajor:
      return launch<kMajor>(q_map, k_map, v_map, o, bh, s_q, s_kv, sc, st);
    case kMajorExp2:
      return launch<kMajorExp2>(q_map, k_map, v_map, o, bh, s_q, s_kv, sc, st);
    default:
      return launch<kNoSoftmax>(q_map, k_map, v_map, o, bh, s_q, s_kv, sc, st);
  }
}
