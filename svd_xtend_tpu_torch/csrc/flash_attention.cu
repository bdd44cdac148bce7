// Non-causal flash attention on the packed (B, S, H*64) layout: the forward
// kernel (the backward pair is csrc/flash_backward.cu), for Hopper (sm_90a).
//
// Replaces svd_xtend_tpu/ops/pallas/flash_attention.py::_fwd_packed_kernel
// (the spatial self-attention of every BasicTransformerBlock), ::_fwd_kernel
// (the head-major entry point: a contiguous (B, S, H, 64) tensor has this
// memory layout) and scripts/microbench_flash_headslice.py::_fwd_headsliced
// (this kernel with its LSE), all read in place on the packed layout. When
// asked (training, the probe) it also writes the f32 log-sum-exp of each
// query row, (B, H, S) in nats, for the backward.
//
// What bounds it on an H100: 4*S*S*64 FLOPs per (batch, head) against
// 4*S*64*2 bytes of q/k/v/o, ~S/2 FLOPs per byte at head_dim 64, far above
// the card's ~295 FLOP/byte ridge: the tensor cores, and right behind them
// the softmax. Per consumer warpgroup and 64 x 64 tile of scores:
//   - Q K^T and P V: 2 x 2*64*64*64 = 1.05 MFLOP, ~256 clocks at the SM's
//     ~4,100 dense bf16 FLOP per clock;
//   - 4,096 exponentials at 16 MUFU.EX2 per clock per SM: ~256 clocks;
//   - ~6 f32 operations per score (max, FFMA, sum, rescale, pack) at 128 per
//     clock: ~190 clocks.
// A warpgroup that runs its softmax between its own products therefore
// waits on it as long as on the tensor cores; the design overlaps them.
//
// Design (the mainloop is csrc/flash_fwd.cuh, shared with the probe's
// softmax organisations in flash_variants.cu):
//   - A block is kC consumer warpgroups of 64 query rows and one producer
//     warpgroup that hands its registers over (setmaxnreg 24 / 240 with two
//     consumers; 232 with one, 160 with three), as the backward pair does.
//     It is persistent: one block per SM (two with kC = 1) walks the
//     (64 * kC-query item, head, sample) items, so the ring runs on from one
//     item into the next. kC is 2, 3 where three warpgroups' 10 % faster
//     rate saves whole rounds of items (generate's 2560 tokens), 1 where the
//     last item would be mostly empty (160 and 40 tokens):
//     consumer_warpgroups below.
//   - K and V come by TMA into a ring of 3 stages (2 with kC = 1) of 128
//     keys each, one 3-D tensor map per operand over (H*64 columns, S rows,
//     B): a box is one head's 64 columns = one 128-byte swizzle atom, and
//     rows past S read as zero within each sample. Full/empty mbarriers per
//     stage. Q comes by TMA too, an item's rows into one of two slots, so
//     the next item's Q is there before the consumers finish this one.
//   - S = Q K^T is a wgmma m64n64k16 per 16 columns with both Q (the
//     warpgroup's 64 rows of the slot) and K read K-major from shared
//     memory; O += P V takes P from the score accumulators as A fragments
//     (bf16, as the JAX kernel rounds it) and V MN-major through the
//     transpose bit, so no thread writes a transposed copy.
//   - Softmax: f32 statistics per 64-key sub-tile in base 2, the row maximum
//     taken on the raw scores and scale * log2(e) folded into one FFMA per
//     score, so the wrapper requires scale > 0; exp2 is one ex2.approx.ftz;
//     each thread keeps a partial row sum, added over its quad at the end.
//     Only the last, partial sub-tile is masked (its keys past S are zero,
//     their scores become -inf). Query rows past S are computed on zeros
//     and not stored.
//   - Overlap: each warpgroup issues S of sub-tile u and P V of sub-tile
//     u - 1 together, runs the softmax of u while the second product is on
//     the tensor cores, and only then waits for it and rescales O
//     (flash_fwd.cuh). Registers: O 32, S 32, P 16 a thread; ptxas: 168
//     (kC = 2) or 128 (kC = 1, 3: the launch bound's share), no spills.
//   - LSE = ln 2 * (m * scale * log2 e + log2 l), written by the thread of
//     each quad that owns the row.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W, device time per launch in a
// CUDA graph, the forward timer that became scripts/bench_flash_forward.py,
// each variant built from a copy of these files in the same call as the
// kept form; ms at (28, 2560, 5 heads) unless named): the kept form 0.564-
// 0.571, the earlier mma.sync kernel 1.89-1.90, SDPA 0.53-0.54. What holds it:
// at the peak rate's 1.83 GHz the 9.2e8 exponentials take 0.237 ms (16
// MUFU.EX2 per clock per SM), the products 0.238 and the ~5 f32 operations
// a score 0.15; the kernel's time is near their sum (0.62), not their
// maximum: the exponentials of one warpgroup run under the other's products
// only in part. Tried and refuted, in order:
//   - the plain pipeline (each warpgroup waits for S, softmax, then P V):
//     0.703 against 0.613 with the overlap;
//   - ping-pong (named barriers alternating the two warpgroups' issue of
//     their products): 0.636-0.639 against 0.605-0.606;
//   - one block per item instead of persistent blocks: at 40 tokens 0.0144
//     against 0.0116-0.0118, at 160 0.0457 against 0.0399-0.0401;
//   - ring depth 2 or 4: 0.647 / 0.598 against 0.590-0.592;
//   - Q as register A fragments read from its swizzled slot: 0.590-0.592
//     (against 0.604-0.610 for Q from shared memory in later calls), but
//     ptxas gave the fragments' registers to other values inside the key
//     loop of the probe's plain-pipelined base mode (its every row wrong),
//     so Q stays a shared-memory operand;
//   - row max and sum as trees of depth 4 instead of chains: 0.642 against
//     0.608; 4 Q slots instead of 2: no change;
//   - keeping a row's maximum until a new one is 2^8 above it, and skipping
//     the rescale of O where no row of the warp moved: 0.612-0.614 against
//     0.604-0.610;
//   - 64-row items everywhere: 0.626 (and 0.0999 against 0.0947 at 640),
//     but 0.0294 against 0.0351 at 160 and 0.0077 against 0.0104 at 40.

#include "flash_fwd.cuh"

namespace {

using namespace flash_fwd;

// A persistent block of kC consumer warpgroups over the (64 * kC-query
// tile, head, batch) items.
template <int kC>
__global__ void __launch_bounds__(Smem<kC>::kThreads, Smem<kC>::kBlocksPerSm)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int s_q, int s_kv,
                 int n_cols, int batch, float scale_log2) {
  extern __shared__ char smem_raw[];
  Smem<kC>& sm = sm90::aligned_smem<Smem<kC>>(smem_raw);
  constexpr int kRows = Smem<kC>::kRows;
  const int heads = n_cols / kD, n_qt = (s_q + kRows - 1) / kRows;
  const int n_items = n_qt * heads * batch, n_stages = (s_kv + kStageKeys - 1) / kStageKeys;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  init_barriers(sm);

  if (wg == kC) {  // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x % 128 == 0)
      produce(sm, &q_map, &k_map, &v_map, n_items, n_qt, heads, n_stages);
  } else {  // consumers
    sm90::setmaxnreg_inc<Smem<kC>::kConsumerRegs>();
    const int t = lane & 3;
    int it0 = 0;
    for (int w = blockIdx.x, ii = 0; w < n_items; w += gridDim.x, ++ii, it0 += n_stages) {
      const Item item = item_of(w, n_qt, heads);
      const int row0 = item.qt * kRows + wg * 64;
      const size_t qoff = (size_t)item.b * s_q * n_cols + (size_t)item.h * kD;
      const uint64_t qd = wait_q(sm, ii, wg);
      OnlineExp2 pol(scale_log2);
      float acc[32];
      consume<true>(sm, qd, acc, pol, s_kv, lane, it0);
      free_q(sm, ii, lane);

      const int r0 = row0 + 16 * warp + (lane >> 2);
      float inv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        pol.l[j] = quad_sum(pol.l[j]);
        inv[j] = pol.l[j] > 0.f ? 1.f / pol.l[j] : 0.f;
      }
      if (lse != nullptr && t == 0) {
        // natural-log LSE of the scaled scores: ln 2 * (m * scale * log2 e + log2 l)
        float* lb = lse + ((size_t)item.b * heads + item.h) * s_q;
        if (r0 < s_q)
          lb[r0] = fmaf(pol.m[0], scale_log2, log2f(pol.l[0])) * 0.6931471805599453f;
        if (r0 + 8 < s_q)
          lb[r0 + 8] = fmaf(pol.m[1], scale_log2, log2f(pol.l[1])) * 0.6931471805599453f;
      }
      store_rows(o + qoff, acc, inv, r0, s_q, n_cols, t);
    }
  }
}

template <int kC>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int b, int s_q,
           int s_kv, int heads, float scale, cudaStream_t stream) {
  const int n_cols = heads * kD;
  CUtensorMap q_map, k_map, v_map;
  int err = sm90::encode_rows_map(&q_map, q, n_cols, s_q, b, Smem<kC>::kRows);
  if (err == 0) err = sm90::encode_rows_map(&k_map, k, n_cols, s_kv, b, kStageKeys);
  if (err == 0) err = sm90::encode_rows_map(&v_map, v, n_cols, s_kv, b, kStageKeys);
  if (err != 0) return err;
  constexpr int smem = sm90::smem_bytes<Smem<kC>>();
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      flash_fwd_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (attr != 0) return attr;
  const int n_items = (s_q + Smem<kC>::kRows - 1) / Smem<kC>::kRows * heads * b;
  flash_fwd_kernel<kC><<<persistent_blocks(n_items, Smem<kC>::kBlocksPerSm),
                         Smem<kC>::kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), s_q,
      s_kv, n_cols, b, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The block shape (consumer warpgroups kC = 1, 2 or 3) with the least
// estimated time for n_seq = heads * batch sequences of s_q queries: the
// rounds in which the resident blocks take the 64 * kC-row items, times the
// 64-row units an SM runs a round (two with kC = 1, two blocks, or 2; three
// with 3), over their rate, which three warpgroups on an SM raise by 10 %
// (NVIDIA H100 80GB HBM3, 700.00 W: 0.564-0.571 against 0.607-0.613 ms at
// (28, 2560, 5 heads), scripts/bench_flash_forward.py on a copy of this
// file that took kC = 3). Another shape replaces the two-warpgroup block
// only where its estimate is 5 % lower: 3 at the UNet's 2560 tokens in
// generate, 1 at 160 and 40, 2 elsewhere.
int consumer_warpgroups(int s_q, int n_seq) {
  const long long slots = sm_count();
  auto cost = [&](int kc) {
    const int per_sm = kc == 1 ? 2 : 1;
    const long long items = (long long)((s_q + 64 * kc - 1) / (64 * kc)) * n_seq;
    const long long rounds = (items + slots * per_sm - 1) / (slots * per_sm);
    return rounds * kc * per_sm * (kc == 3 ? 100 : 110);  // x 110 / rate
  };
  int best = 2;
  for (int kc : {1, 3})
    if (cost(kc) * 100 < cost(best) * 95) best = kc;
  return best;
}

}  // namespace

// q: (b, s_q, heads*64), k/v: (b, s_kv, heads*64), o like q; all bf16,
// contiguous, 16-byte aligned; lse: f32 (b, heads, s_q) or null; scale > 0.
// Returns cudaErrorInvalidValue without launching for a scale <= 0 or a
// geometry the tensor-map encoder refuses, else cudaGetLastError() after
// the launch.
extern "C" int svdx_flash_attention_fwd(const void* q, const void* k, const void* v,
                                        void* o, void* lse, int b, int s_q, int s_kv,
                                        int heads, float scale, void* stream) {
  if (!(scale > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch (consumer_warpgroups(s_q, heads * b)) {
    case 1:
      return launch<1>(q, k, v, o, lse, b, s_q, s_kv, heads, scale, st);
    case 3:
      return launch<3>(q, k, v, o, lse, b, s_q, s_kv, heads, scale, st);
    default:
      return launch<2>(q, k, v, o, lse, b, s_q, s_kv, heads, scale, st);
  }
}
