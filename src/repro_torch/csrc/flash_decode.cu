// Flash attention over a GQA KV cache, paged (kernels K1, K5, K6) or
// contiguous (kernel K7), and over an absorbed-MLA latent pool (kernels
// K8, K9, K10).
//
// Replaces the TPU kernels of src/repro/kernels/flash_decode.py that share
// the Pallas body `_softmax_tile` under the `_flash_core` scalar-prefetch
// grid:
//   K1  flash_decode_gqa_paged, chunk=1 (via flash_decode_paged): one query
//       token per request; q (B, Hkv, G, dh) f32, k/v pools
//       (P, page_size, Hkv, dh) bf16 or f32, pos/window (B,) int32, block
//       tables (B, W) int32; attends pos - window < kpos <= pos.
//   K5  flash_decode_gqa_paged, chunk=C>1 (via flash_chunk_paged): C*G
//       query rows per (request, KV head), row r at position
//       offset + r / G, each with its own causal/window mask; pos/window
//       are the fetch-union scalars (the chunk's last valid position, and
//       the window widened by C - 1), so the live-page range covers every
//       row and each row re-derives its own validity inside the split.
//   K6  flash_decode_gqa_paged_q8 (via flash_decode_paged_q8): K1 over the
//       hybrid tier. Block s is hot iff s > max(pos, 0) / page_size - hw;
//       a hot page is read from the fp pools, a cold one from the int8
//       pools times its per-page, per-head f32 scale, the product rounded
//       through the pool dtype as the reference's loader and
//       dequant_gather round it. Each page is read from one tier only.
//   K7  flash_decode_gqa (via flash_decode): K1's function over a
//       contiguous cache; k/v (B, S, Hkv, dh) bf16 or f32, key (b, kpos)
//       at ((b * S + kpos) * Hkv + h) * dh, no block table. The reference
//       pads k/v to a tile multiple on every call (a copy of each layer's
//       cache a step); here keys at or past S are never read, the same
//       function without the copy. The streamed flag (the reference's
//       legacy baseline, impl='streamed') walks every tile of [0, S) and
//       masks, with output bit-equal to the prefetch walk.
//   K8  flash_decode_mla_paged, chunk=1 (via flash_decode_paged_mla):
//       absorbed MLA decode. q (B, 1, H, DK) f32 (DK = r + d_rope = 576
//       for deepseek-v3: the query absorbed through W_uk, then the rope
//       query), one latent pool (P, page_size, DK) bf16 or f32 holding
//       ckv | krope per token. MLA is GQA with ONE KV head and G = H query
//       rows sharing it: a latent tile is staged once and used twice, all
//       DK columns as the keys, its first DV = r columns as the values.
//   K9  flash_decode_mla_paged, chunk=C>1 (via flash_chunk_paged_mla): K8
//       over C*H rows, row i at offset + i / H, K5's row policy with
//       group = H and its fetch-union scalars (rows at or past the
//       chunk's limit are padding: finite, never read back).
//   K10 flash_decode_mla_paged_q8 (via flash_decode_paged_mla_q8): K8 over
//       the int8 latent tier; a cold page reads clq * cs[page] (ONE scale
//       per page: the latent is shared by every head) rounded through the
//       pool dtype, a hot page the fp pool, each page from one tier only.
//       Block s is hot iff s > max(pos, 0) / page_size - hw.
// K1, K5, K6 and K7 return f32 (B, Hkv, rows, dh); K8, K9 and K10 return
// the f32 latent output (B, 1, rows, DV), never cast to the pool dtype (the
// caller applies W_uv).
//
// Which kernel serves which entry point:
//   key_split_kernel + split_combine_kernel (the key split, below), one
//   kernel body over three row loaders: K7 (flash_decode_contig, ContigKV),
//   K1 (flash_decode_paged, PagedKV), K6 (flash_decode_paged_q8,
//   TieredPagedKV) and, with its chunk rows, K5 (flash_chunk_paged,
//   PagedKV).
//   latent_split_kernel + split_combine_kernel (the latent key split,
//   below), one kernel body for K8 (flash_decode_paged_mla) and K10
//   (flash_decode_paged_mla_q8), K10 passing the int8 tier and K8 none,
//   and, with its chunk rows, K9 (flash_chunk_paged_mla).
// All copy the reference's online softmax; what differs between entry
// points of one body is the loader and the row positions (one position
// for decode, offset + r / group for a chunk).
//
// Bound on the H100: bytes for K1/K5/K6/K7 (each live key is read once,
// from device memory, and used for 2*G*dh multiply-adds a row, far below
// the card's operations-per-byte balance; K5's C*G rows a key still leave
// it bytes-bound at the serving chunk sizes). K8/K9/K10: see the latent
// key split.
//
// The key split: one block per (request, KV head, key split, group of at
// most 2 query rows), so a batch of 8 x 32 heads gives 768 blocks at 160
// keys where one block per head gave 256 blocks of 5 serial passes. The
// wrapper plans the split from the shapes only
// (kernels/flash_decode.py::contig_split_plan, paged_split_plan): absolute
// tiles of at least 64 keys (whole pages when paged), whole tiles a split;
// a split whose tiles hold none of the live keys [max(pos - win + 1, 0),
// min(pos, S - 1)] (S = W * page_size when paged) writes m = -inf and
// exits, and a live split visits only its live tiles (every tile when
// streamed, K7's legacy baseline). Inside a split, lpk lanes read one key
// row with 16-byte loads (8 bf16 or 4 f32 a lane; an f32 row of dh > 128,
// up to 256, takes two pieces a lane, a template instance of its own, so
// the one-piece instances compile as before) and reduce its dot
// products by shuffles, so no two lanes of a warp read one shared-memory
// bank; each lane group keeps its own online softmax over the keys it owns
// (no block barrier in the key loop), the groups merge by shuffles and the
// warps through shared memory in a fixed order, and the query rows of the
// block share every key row read. The splits' partials (m, l,
// unnormalised acc, in the wrapper's scratch) are merged by the combine
// kernel in split order with `_softmax_tile`'s guards (a split whose m is
// -inf weighs 0) and normalised once. Masked keys are not read and weigh
// exactly 0, and the tiles are absolute, so K7's streamed walk, which only
// adds masked tiles and splits, gives bit-equal output.
// The row loaders map (b, kpos, h) to the lane's piece of a key and value
// row. ContigKV: ((b * S + kpos) * Hkv + h) * dh. PagedKV: the same row
// through the block table, ((bt[b][kpos / ps] * ps + kpos % ps) * Hkv + h)
// * dh, so a key row of one head is dh contiguous elements, strided by
// Hkv * dh from the next key, as in the contiguous cache; a live split
// stages its pages' ids in shared memory once, before the key loop.
// TieredPagedKV: PagedKV's rows for a hot page, for a cold one (block <
// max(pos, 0) / ps - hw + 1) only the lane's int8 codes (8 bytes against
// bf16 pools, 4 against f32) times the page's (page, h) scales, staged
// once a page, each product rounded through the pool dtype, so each page
// is read from one tier only. Its hot keys take PagedKV's loads and the
// same arithmetic, so K6 equals K1 bit for bit when the hot window covers
// the table.
// K5 is K1's kernel with chunk rows (kChunk, planned by chunk_split_plan):
// a block's C*G query rows sit at offset + r / G, each row with the window
// win - (C - 1) of the fetch-union scalars; the block narrows the live
// keys to what its own rows can see, and each row masks its own keys in
// the lane group's online softmax, so one key row read serves the block's
// 2 query rows (chunk_split_plan: of 2, 4 and 8 timed on the H100, 2 won
// at bf16, where 8 rows take 255 registers and a quarter of the
// occupancy; only the 2-row instance is built). K1 keeps its own instance
// (kChunk = false) bit for bit.
//
// The latent key split (K8, K9, K10). MLA is GQA with one KV head and all
// H = 128 query rows sharing every latent row, so a key tile's work is two
// small matrix products, QK^T (H x DK . DK x keys) and PV (H x keys . keys
// x DV). What bounds them on the H100 at deepseek-v3's width (DK = 576,
// DV = 512, bf16 pool): at the serving row (8 slots of <= 160 keys) the
// ~1.1 MB of latent over 3.35 TB/s, 0.0017 ms, far below two launches, so
// launch and latency; at a long context the products: 2*H*(DK + DV) = 279
// kflop a key against its 1152 bytes is 242 flop a byte, below the bf16
// balance of ~295, but each product is done three times (below), 725 a
// byte, so the MMA work bounds it.
// The design:
// - Tensor cores with f32 accuracy. Both products run as mma.sync
//   m16n8k16 bf16 -> f32. Every f32 operand (the query, the probabilities,
//   an f32 latent) is split into three bf16 parts, x = x1 + x2 + x3 exactly
//   (split3_pair: truncation keeps 8 significant bits a part), built in
//   registers as the fragments are; a bf16 latent is exact, so each product
//   takes three MMAs (six on an f32 latent). A plain bf16 product of the
//   f32 query would miss the 2e-5 tolerance by two orders of magnitude.
// - Blocks of 32 query rows (two m-tiles, 8 warps) and one key split of
//   whole pages each, planned from the shapes only
//   (kernels/flash_decode.py::latent_split_plan): the most splits that
//   fill the SMs in the fewest waves, since each split's partials (H x DV
//   floats) cost what ~230 bf16 keys of latent do. Each latent row is read
//   H / 32 = 4 times a slot, the repeats from L2.
// - The latent staged once a step, used twice: one bulk copy a row (its
//   DK values in the pool dtype) by warp 0 onto the stage's mbarrier,
//   4 steps of 32 keys in flight (2 for f32); QK^T reads the tile's rows
//   (ldmatrix), PV its first DV columns transposed (ldmatrix .trans). The
//   row stride DK + 8 puts the 8 rows an ldmatrix reads in distinct banks.
// - Registers: a warp owns one m-tile and one quarter of the DK columns
//   for QK^T, its query parts held for the whole call (108 registers), and
//   one quarter of the DV columns for PV (16 value tiles, 64 accumulator
//   registers; a 16 x 512 accumulator in one warp would need 256). The
//   quarters' logits are summed in order in shared memory, and the step's
//   softmax is computed once there by all threads, not by each warp.
// - K10's cold rows arrive as codes in the last DK bytes of their own row
//   and become the pool dtype's values there, one warp a row, before the
//   products: the products are the same code for both tiers, so K10 = K8
//   bit for bit when no row is cold.
// - The splits' partials are merged by the key split's combine
//   (split_combine_kernel) with g = H and dh = DV.
//
// K9 is the same kernel with chunk rows (kChunk, planned by
// latent_split_plan for the C*H rows as K8's plan is for H): a block's 32
// query rows sit at offset + i / H, each with the window win - (C - 1) of
// the fetch-union scalars. The block narrows the live keys to the union of
// its rows' ranges, [qp_first - row_win + 1, qp_last] within [lo, hi], so
// the dead-split test, the step walk and the zeroing of masked rows take
// that range, and each row masks its own keys in the step's softmax (its
// clipped range staged in shared memory once). At deepseek-v3's H = 128 a
// block holds one position and the mask is the block's; a narrower H puts
// several positions in a block. The bound is the f32 query and output at a
// prefix hit's suffix (C = 8 at ~100 keys: 4.5 MB against 0.2 Gflop), the
// MMA work at a long context. K8 and K10 keep their own instance
// (kChunk = false).
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

// an f32 value in the pool dtype (round to nearest even for bf16): a
// dequantized value goes through it as the reference's loader casts it
// (`.astype(k_ref.dtype)`)
template <typename KV>
__device__ __forceinline__ KV from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// The key split (K1, K6, K7): the key axis split over blocks
// ---------------------------------------------------------------------------
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kStepKeys = 4;     // keys a lane group takes per update

// the int8 codes of a row that sit beside the Vec<KV>::n elements of a
// 16-byte piece (8 bytes against bf16 pools, 4 against f32), from p, in
// the low bytes of a uint2: `n_valid` codes (<= 0: none, zeros); the
// aligned form needs p aligned to that size and n_valid <= 0 or >= it
template <typename KV, bool kAligned>
__device__ __forceinline__ uint2 load_codes(const int8_t* p, int n_valid) {
  constexpr int V = Vec<KV>::n;
  if (n_valid <= 0) return make_uint2(0, 0);
  if (kAligned) {
    if constexpr (V == 8) return __ldg(reinterpret_cast<const uint2*>(p));
    return make_uint2(__ldg(reinterpret_cast<const unsigned int*>(p)), 0);
  }
  uint32_t w[2] = {0, 0};
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (e < n_valid)
      w[e / 4] |= static_cast<uint32_t>(__ldg(
                      reinterpret_cast<const unsigned char*>(p) + e))
                  << (8 * (e % 4));
  return make_uint2(w[0], w[1]);
}

// codes c (as load_codes gives them) times scale, each product rounded
// through the pool dtype (to nearest even), packed as its bits:
// the piece an fp row would give. Codes at or past n_valid give 0.
template <typename KV>
__device__ __forceinline__ uint4 dequant(uint2 c, float scale, int n_valid) {
  constexpr int V = Vec<KV>::n;
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (e >= n_valid) continue;
    const uint32_t word = e < 4 ? c.x : c.y;
    const int code = static_cast<int8_t>((word >> (8 * (e % 4))) & 0xffu);
    const float x = __fmul_rn(static_cast<float>(code), scale);
    if constexpr (sizeof(KV) == 4)
      w[e] = __float_as_uint(x);
    else
      w[e / 2] |= static_cast<uint32_t>(
                      __bfloat16_as_ushort(__float2bfloat16_rn(x)))
                  << (16 * (e % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Row loaders of the key split. fetch() gives the 16-byte pieces at d0 of
// the key and value rows of key kpos of request b, head h, in the pool
// dtype's bits (zeros where !ok: a masked key is not read), or, where it
// returns true, a cold key's int8 codes and their scales, for dequant()
// once the step's loads are in flight. A loader with kStaged > 0 stages
// kStaged ints a page of the split's live pages in shared memory (stage(),
// before the key loop), at most n_stage pages.

// K7: a contiguous (B, S, Hkv, dh) cache.
template <typename KV_>
struct ContigKV {
  using KV = KV_;
  static constexpr int kStaged = 0;
  static constexpr bool kTiered = false;
  const KV* __restrict__ k;
  const KV* __restrict__ v;
  int s, hkv;                      // keys a request, KV heads

  __device__ __forceinline__ int stage(int*, int, int, int, int, int) {
    return 0;
  }
  template <bool kAligned>
  __device__ __forceinline__ bool fetch(int b, int kpos, int h, int dh,
                                        int d0, bool ok, uint4& kr,
                                        uint4& vr, float&, float&) const {
    const int n_el = ok ? dh - d0 : 0;
    const int64_t off =
        ((static_cast<int64_t>(b) * s + (ok ? kpos : 0)) * hkv + h) * dh +
        d0;
    kr = load_raw<KV, kAligned>(k + off, n_el);
    vr = load_raw<KV, kAligned>(v + off, n_el);
    return false;
  }
};

// K1: pools (P, ps, Hkv, dh) through block tables (B, W); a split's live
// pages' ids are staged once.
template <typename KV_>
struct PagedKV {
  using KV = KV_;
  static constexpr int kStaged = 1;
  static constexpr bool kTiered = false;
  const KV* __restrict__ k;
  const KV* __restrict__ v;
  const int* __restrict__ bt;
  int s, hkv, w, ps, n_stage;      // s = w * ps keys a request
  const int* pages;                // staged ids of blocks blk0, blk0 + 1, ..
  int blk0;

  // stage the ids of blocks [k_lo / ps, k_hi / ps] (none if k_hi < k_lo);
  // returns their count
  __device__ __forceinline__ int stage(int* s_stage, int b, int, int,
                                       int k_lo, int k_hi) {
    blk0 = k_lo / ps;
    const int n = k_hi < k_lo ? 0 : k_hi / ps - blk0 + 1;
    const int* row = bt + static_cast<int64_t>(b) * w + blk0;
    for (int i = threadIdx.x; i < n; i += kSplitThreads) s_stage[i] = row[i];
    pages = s_stage;
    return n;
  }
  // element offset of (kpos, h) in a pool, kpos in block blk
  __device__ __forceinline__ int64_t offset(int kpos, int blk, int h,
                                            int dh) const {
    return ((static_cast<int64_t>(pages[blk - blk0]) * ps + kpos - blk * ps) *
                hkv + h) * dh;
  }
  template <bool kAligned>
  __device__ __forceinline__ bool fetch(int, int kpos, int h, int dh, int d0,
                                        bool ok, uint4& kr, uint4& vr, float&,
                                        float&) const {
    const int n_el = ok ? dh - d0 : 0;
    const int64_t off = ok ? offset(kpos, kpos / ps, h, dh) + d0 : 0;
    kr = load_raw<KV, kAligned>(k + off, n_el);
    vr = load_raw<KV, kAligned>(v + off, n_el);
    return false;
  }
};

// K6: PagedKV over the fp/int8 tier pair, (P, Hkv) f32 scales and a (1,)
// hot window in device memory. Block blk is hot iff blk >= first_hot =
// max(pos, 0) / ps - hw + 1; a hot key takes PagedKV's fetch, a cold one
// only its codes, the staged scales of its page (read for cold pages only)
// beside them.
template <typename KV_>
struct TieredPagedKV : PagedKV<KV_> {
  using KV = KV_;
  using Fp = PagedKV<KV_>;
  static constexpr int kStaged = 3;   // page id, k scale, v scale
  static constexpr bool kTiered = true;
  const int8_t* __restrict__ kq;
  const int8_t* __restrict__ vq;
  const float* __restrict__ ks;
  const float* __restrict__ vs;
  const int* __restrict__ hw;
  const float* sk;                 // staged scales, as pages
  const float* sv;
  int first_hot;

  // PagedKV's stage, then the scales of the cold pages among them
  __device__ __forceinline__ int stage(int* s_stage, int b, int h, int pos,
                                       int k_lo, int k_hi) {
    const int n = Fp::stage(s_stage, b, h, pos, k_lo, k_hi);
    first_hot = max(pos, 0) / this->ps - hw[0] + 1;
    float* fk = reinterpret_cast<float*>(s_stage + this->n_stage);
    float* fv = fk + this->n_stage;
    // each thread reads back only the ids it staged itself: no barrier
    for (int i = threadIdx.x; i < n && this->blk0 + i < first_hot;
         i += kSplitThreads) {
      const int64_t sc = static_cast<int64_t>(s_stage[i]) * this->hkv + h;
      fk[i] = ks[sc];
      fv[i] = vs[sc];
    }
    sk = fk;
    sv = fv;
    return n;
  }
  template <bool kAligned>
  __device__ __forceinline__ bool fetch(int b, int kpos, int h, int dh,
                                        int d0, bool ok, uint4& kr,
                                        uint4& vr, float& kc,
                                        float& vc) const {
    const int blk = kpos / this->ps;
    if (ok && blk < first_hot) {
      const int64_t off = this->offset(kpos, blk, h, dh) + d0;
      const uint2 ck = load_codes<KV, kAligned>(kq + off, dh - d0);
      const uint2 cv = load_codes<KV, kAligned>(vq + off, dh - d0);
      kr = make_uint4(ck.x, ck.y, 0, 0);
      vr = make_uint4(cv.x, cv.y, 0, 0);
      kc = sk[blk - this->blk0];
      vc = sv[blk - this->blk0];
      return true;
    }
    return Fp::template fetch<kAligned>(b, kpos, h, dh, d0, ok, kr, vr, kc,
                                        vc);
  }
};

// The lane's kPieces pieces, at d0 + c * pstride, of the key and value
// rows of keys k0 + u * pass, u < kStepKeys; a masked key (outside
// [lo, hi]) is not read: its p is 0 and its value row stays 0, and a piece
// past dh reads nothing. A cold key's codes wait in kr/vr for
// dequant_step.
template <typename Rows, bool kAligned, int kPieces>
__device__ __forceinline__ void fetch_step(
    const Rows& kv, int b, int h, int dh, int d0, int pstride, int lo,
    int hi, int k0, int pass, uint4 (&kr)[kStepKeys][kPieces],
    uint4 (&vr)[kStepKeys][kPieces], bool (&ok)[kStepKeys],
    bool (&cold)[kStepKeys], float (&kc)[kStepKeys],
    float (&vc)[kStepKeys]) {
#pragma unroll
  for (int u = 0; u < kStepKeys; ++u) {
    const int kpos = k0 + u * pass;
    ok[u] = kpos >= lo && kpos <= hi;
#pragma unroll
    for (int c = 0; c < kPieces; ++c)
      cold[u] = kv.template fetch<kAligned>(b, kpos, h, dh, d0 + c * pstride,
                                            ok[u], kr[u][c], vr[u][c], kc[u],
                                            vc[u]);
  }
}

// A step's cold codes to the pool dtype's bits (tiered loaders only), once
// all its loads are in flight: the step's compute then reads every key as
// K1 reads it, in one branch-free block, so the compiler makes the same
// arithmetic of both and K6 over hot pages equals K1 bit for bit.
// n_valid: the elements of the row from the lane's first piece on.
template <typename Rows, int kPieces>
__device__ __forceinline__ void dequant_step(
    uint4 (&kr)[kStepKeys][kPieces], uint4 (&vr)[kStepKeys][kPieces],
    const bool (&cold)[kStepKeys], const float (&kc)[kStepKeys],
    const float (&vc)[kStepKeys], int n_valid, int pstride) {
  if constexpr (Rows::kTiered) {
    using KV = typename Rows::KV;
#pragma unroll
    for (int u = 0; u < kStepKeys; ++u)
      if (cold[u]) {
#pragma unroll
        for (int c = 0; c < kPieces; ++c) {
          const int n = n_valid - c * pstride;
          kr[u][c] = dequant<KV>(make_uint2(kr[u][c].x, kr[u][c].y), kc[u],
                                 n);
          vr[u][c] = dequant<KV>(make_uint2(vr[u][c].x, vr[u][c].y), vc[u],
                                 n);
        }
      }
  }
}

// The weight of an online-softmax state whose max is m in a merge whose
// max is m_new, with _softmax_tile's guard: a state whose max is -inf
// weighs 0. Every running max here is taken with fmax_nan, so a state that
// saw a NaN logit has m = NaN, not -inf: its weight, and so the merge, is
// NaN, as jnp.max makes the reference's row NaN. A -inf max therefore
// means the state saw no key, and the dead-state tests below (`== -inf`:
// skip) never drop a NaN. A NaN value row behind a finite logit reaches the
// accumulator through p * v.
__device__ __forceinline__ float merge_weight(float m, float m_new) {
  return m == -INFINITY ? 0.f : expf(m - m_new);
}

// The query rows of a chunk (K5, K9): row r of a (request b, KV head) sits
// at off[b] + r / group and attends (qp - (win - (chunk - 1)), qp]; for
// decode (K1, K6, K7, K8, K10) off is null and every row sits at pos.
struct ChunkRows {
  const int* __restrict__ off;
  int chunk, group;
};

// One block: (b, h) = blockIdx.x, key split blockIdx.y, query rows
// [blockIdx.z * kRows, +kRows) of g. Keys are cut into absolute tiles of
// `tile` keys, `tiles_per_split` of them a split. The live keys are
// [lo, hi] = [max(pos - win + 1, 0), min(pos, S - 1)] (S = kv.s); unless
// `streamed`, only the tiles holding them are visited, and a split holding
// none writes m = -inf and exits. A staging loader then stages the split's
// live pages (one barrier). Lane group `grp` (lpk lanes, kPieces 16-byte
// pieces of a row each: lane li holds elements li * V + c * lpk * V, c <
// kPieces, so each piece's loads are contiguous across the group; kPieces
// = 2 only for f32 rows wider than the 128 elements one piece a lane
// covers, dh <= 256) owns key kb + u * (kSplitWarps * 32 / lpk) + warp *
// (32 / lpk) +
// grp of each step kb and keeps its own online-softmax state over them
// (no block barrier in the key loop); the groups merge by shuffles, then
// the warps through shared memory, in a fixed order. The split's partial
// (m, l, unnormalised acc) goes to part_*. With kChunk (K5) pos and win
// are the chunk's fetch-union scalars; the block narrows [lo, hi] to the
// keys its own rows can see, and each row masks its own keys inside the
// lane group's online softmax (logit -inf, p = 0), so a row with no
// valid key in a split leaves that split's m at -inf.
template <typename Rows, int kRows, bool kAligned, bool kChunk, int kPieces>
__global__ void __launch_bounds__(kSplitThreads)
key_split_kernel(Rows loader, const float* __restrict__ q,
                 const int* __restrict__ pos_v, const int* __restrict__ win_v,
                 ChunkRows chunk, float* __restrict__ part_m,
                 float* __restrict__ part_l, float* __restrict__ part_acc,
                 int g, int dh, int lpk, int tile, int tiles_per_split,
                 int n_splits, int streamed, float scale) {
  constexpr int V = Vec<typename Rows::KV>::n;
  constexpr int E = kPieces * V;     // a lane's elements of a row
  extern __shared__ float s_red[];   // m, l: kSplitWarps * kRows; acc; stage
  float* s_m = s_red;
  float* s_l = s_m + kSplitWarps * kRows;
  float* s_acc = s_l + kSplitWarps * kRows;   // kSplitWarps * kRows * dh

  Rows kv = loader;   // stage() fills in the split's staged pages
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / kv.hkv, h = bh % kv.hkv;
  const int r0 = blockIdx.z * kRows, nr = min(kRows, g - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kpw = 32 / lpk, grp = lane / lpk, li = lane % lpk;
  const int d0 = li * V;                        // this lane's 16 bytes
  const int pstride = lpk * V;                  // ... and its next piece's
  const int pos = pos_v[b], win = win_v[b];
  int lo = max(pos - win + 1, 0), hi = min(pos, kv.s - 1);
  // a chunk row's position and window
  int qp[kRows];
  int row_win = 0;
  if constexpr (kChunk) {
    const int base = chunk.off[b];
    row_win = win - (chunk.chunk - 1);
#pragma unroll
    for (int r = 0; r < kRows; ++r) qp[r] = base + (r0 + r) / chunk.group;
    lo = max(lo, qp[0] - row_win + 1);
    hi = min(hi, base + (r0 + nr - 1) / chunk.group);
  }
  // whether row r sees key kpos of the block's range (ok: in [lo, hi])
  auto sees = [&](int r, int kpos, bool ok) {
    if constexpr (kChunk)
      return ok && kpos <= qp[r] && kpos > qp[r] - row_win;
    return ok;
  };
  const int64_t p0 = (static_cast<int64_t>(bh) * n_splits + split) * g + r0;

  const int n_tiles = (kv.s + tile - 1) / tile;
  int t_begin = split * tiles_per_split;
  int t_end = min(t_begin + tiles_per_split, n_tiles);
  if (!streamed) {
    t_begin = max(t_begin, lo / tile);
    t_end = lo <= hi ? min(t_end, hi / tile + 1) : t_begin;
  }
  if (t_begin >= t_end) {
    for (int r = tid; r < nr; r += kSplitThreads) part_m[p0 + r] = -INFINITY;
    return;
  }

  const int pass = kSplitWarps * kpw;           // keys a block covers at once
  const int span = pass * kStepKeys;            // keys a step
  const int key0 = warp * kpw + grp;
  const int k_first = t_begin * tile, k_last = t_end * tile;
  if constexpr (Rows::kStaged > 0) {
    kv.stage(reinterpret_cast<int*>(s_acc + kSplitWarps * kRows * dh), b, h,
             pos, max(k_first, lo), min(k_last - 1, hi));
    __syncthreads();
  }
  uint4 kr[kStepKeys][kPieces], vr[kStepKeys][kPieces];
  bool ok[kStepKeys], cold[kStepKeys];
  float kc[kStepKeys], vc[kStepKeys];
  // in flight while the query is read; later steps' loads overlap other
  // blocks' work
  fetch_step<Rows, kAligned>(kv, b, h, dh, d0, pstride, lo, hi,
                             k_first + key0, pass, kr, vr, ok, cold, kc, vc);

  float qv[kRows][E], acc[kRows][E], m_run[kRows], l_run[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float* qr = q + (static_cast<int64_t>(bh) * g + r0 + r) * dh;
#pragma unroll
    for (int c = 0; c < kPieces; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int d = d0 + c * pstride + e;
        qv[r][c * V + e] = (r < nr && d < dh) ? qr[d] : 0.f;
        acc[r][c * V + e] = 0.f;
      }
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  for (int kb = k_first; kb < k_last; kb += span) {
    if (kb != k_first)
      fetch_step<Rows, kAligned>(kv, b, h, dh, d0, pstride, lo, hi,
                                 kb + key0, pass, kr, vr, ok, cold, kc, vc);
    dequant_step<Rows>(kr, vr, cold, kc, vc, dh - d0, pstride);
    float logit[kRows][kStepKeys];
#pragma unroll
    for (int u = 0; u < kStepKeys; ++u) {
      float kf[kPieces][V];
#pragma unroll
      for (int c = 0; c < kPieces; ++c) unpack(kr[u][c], kf[c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < kPieces; ++c)
#pragma unroll
          for (int e = 0; e < V; ++e) dot += qv[r][c * V + e] * kf[c][e];
        for (int off = 1; off < lpk; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        logit[r][u] = sees(r, kb + key0 + u * pass, ok[u]) ? dot * scale
                                                          : -INFINITY;
      }
    }
    // the online update: logit[r][u] becomes p, acc is rescaled, then the
    // step's values are added key by key
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float mx = logit[r][0];
#pragma unroll
      for (int u = 1; u < kStepKeys; ++u) mx = fmax_nan(mx, logit[r][u]);
      const float m_new = fmax_nan(m_run[r], mx);
      // all-masked guards: exp(-inf - -inf) must contribute 0, not 1
      const float alpha = isfinite(m_run[r]) ? expf(m_run[r] - m_new) : 0.f;
      float p_sum = 0.f;
#pragma unroll
      for (int u = 0; u < kStepKeys; ++u) {
        logit[r][u] = sees(r, kb + key0 + u * pass, ok[u])
                          ? expf(logit[r][u] - m_new)
                          : 0.f;
        p_sum += logit[r][u];
      }
      l_run[r] = l_run[r] * alpha + p_sum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
      m_run[r] = m_new;
    }
#pragma unroll
    for (int u = 0; u < kStepKeys; ++u) {
      float vf[kPieces][V];
#pragma unroll
      for (int c = 0; c < kPieces; ++c) unpack(vr[u][c], vf[c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kPieces; ++c)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[r][c * V + e] += logit[r][u] * vf[c][e];
    }
  }

  // merge the lane groups of each warp (xor over the group bits); the merge
  // is symmetric bit for bit (IEEE + and * commute), so both lanes of each
  // exchange hold the same state after it
  for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m_run[r], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l_run[r], off);
      const float m_new = fmax_nan(m_run[r], mo);
      const float wa = merge_weight(m_run[r], m_new);
      const float wb = merge_weight(mo, m_new);
      l_run[r] = l_run[r] * wa + lo_ * wb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * wa + ao * wb;
      }
      m_run[r] = m_new;
    }
  }
  // then the warps, in warp order
  if (lane < lpk) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (lane == 0) {
        s_m[warp * kRows + r] = m_run[r];
        s_l[warp * kRows + r] = l_run[r];
      }
#pragma unroll
      for (int c = 0; c < kPieces; ++c)
#pragma unroll
        for (int e = 0; e < V; ++e)
          if (d0 + c * pstride + e < dh)
            s_acc[(warp * kRows + r) * dh + d0 + c * pstride + e] =
                acc[r][c * V + e];
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * dh; i += kSplitThreads) {
    const int r = i / dh, d = i - r * dh;
    float m_all = -INFINITY;
    for (int w = 0; w < kSplitWarps; ++w)
      m_all = fmax_nan(m_all, s_m[w * kRows + r]);
    float l_all = 0.f, a_all = 0.f;
    for (int w = 0; w < kSplitWarps; ++w) {
      const float mw = s_m[w * kRows + r];
      if (mw == -INFINITY) continue;
      const float wt = expf(mw - m_all);
      l_all += s_l[w * kRows + r] * wt;
      a_all += s_acc[(w * kRows + r) * dh + d] * wt;
    }
    part_acc[(p0 + r) * dh + d] = a_all;
    if (d == 0) {
      part_m[p0 + r] = m_all;
      part_l[p0 + r] = l_all;
    }
  }
}

// Combine: for every (b, h) row, merge the splits' partials in split order
// (a split whose m is -inf saw no key and weighs 0; one whose m is NaN saw a
// NaN and makes the row NaN) and normalise once, acc / max(l, 1e-30). Block (bh, y) writes outputs [128 kVec y, +128 kVec) of the
// (g, dh) rows of bh, kVec consecutive ones a thread (kVec = 4 when dh is a
// multiple of 4), and stages the m and l of only the rows those outputs lie
// in (one row of K8's 128 at dh = 512). The first kBatch splits'
// accumulators are in flight while m and l are staged; a dead split's
// accumulator (never written) is loaded but not used.
template <int kVec>
__global__ void __launch_bounds__(kSplitThreads)
split_combine_kernel(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc,
                     float* __restrict__ out, int g, int dh, int n_splits) {
  extern __shared__ float s_ml[];   // m, then l: n_splits * nr
  using VecT = typename std::conditional<kVec == 4, float4, float>::type;
  constexpr int kBatch = 8;         // splits whose accumulators load at once
  const int i0 = blockIdx.y * kSplitThreads * kVec;
  const int r_lo = i0 / dh;
  const int nr = min(g - 1, (i0 + kSplitThreads * kVec - 1) / dh) - r_lo + 1;
  const int n = n_splits * nr;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n_splits * g;
  const int i = i0 + threadIdx.x * kVec;
  const bool active = i < g * dh;
  const int r = active ? i / dh : r_lo, d = i - r * dh, rr = r - r_lo;
  auto load = [&](int s0, VecT (&a)[kBatch]) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (active && s0 + j < n_splits)
        a[j] = *reinterpret_cast<const VecT*>(
            part_acc + (base + (s0 + j) * g + r) * dh + d);
  };
  VecT a[kBatch];
  load(0, a);
  for (int k = threadIdx.x; k < n; k += kSplitThreads) {
    const int s = k / nr, row = r_lo + k - s * nr;
    s_ml[k] = part_m[base + s * g + row];
    s_ml[n + k] = part_l[base + s * g + row];
  }
  __syncthreads();
  if (!active) return;
  float m_all = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    m_all = fmax_nan(m_all, s_ml[s * nr + rr]);
  float l_all = 0.f, a_all[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) a_all[e] = 0.f;
  for (int s0 = 0; s0 < n_splits; s0 += kBatch) {
    if (s0 > 0) load(s0, a);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = s0 + j;
      if (s >= n_splits) break;
      const float ms = s_ml[s * nr + rr];
      if (ms == -INFINITY) continue;
      const float wt = expf(ms - m_all);
      l_all += s_ml[n + s * nr + rr] * wt;
      const float* av = reinterpret_cast<const float*>(&a[j]);
#pragma unroll
      for (int e = 0; e < kVec; ++e) a_all[e] += av[e] * wt;
    }
  }
  VecT o;
  float* ov = reinterpret_cast<float*>(&o);
#pragma unroll
  for (int e = 0; e < kVec; ++e) ov[e] = a_all[e] / fmaxf(l_all, 1e-30f);
  *reinterpret_cast<VecT*>(out + (base / n_splits + r) * dh + d) = o;
}

template <int kVec>
int launch_combine_vec(const float* pm, const float* pl, const float* pa,
                       float* out, int bhkv, int g, int dh, int n_splits,
                       cudaStream_t stream) {
  constexpr int span = kSplitThreads * kVec;       // outputs a block
  const int rows = min(g, (span - 1) / dh + 2);
  const size_t smem = sizeof(float) * 2 * n_splits * rows;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_combine_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(bhkv, (g * dh + span - 1) / span);
  split_combine_kernel<kVec><<<grid, kSplitThreads, smem, stream>>>(
      pm, pl, pa, out, g, dh, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// The combine of bhkv (request, KV head) rows of g x dh outputs, each split
// n_splits ways (the partials' layout of key_split_kernel and
// latent_split_kernel).
int launch_combine(const float* pm, const float* pl, const float* pa,
                   float* out, int bhkv, int g, int dh, int n_splits,
                   cudaStream_t stream) {
  return dh % 4 == 0 ? launch_combine_vec<4>(pm, pl, pa, out, bhkv, g, dh,
                                             n_splits, stream)
                     : launch_combine_vec<1>(pm, pl, pa, out, bhkv, g, dh,
                                             n_splits, stream);
}

// Dynamic shared memory of a key_split_kernel block: the warps' partials
// and the loader's staged pages.
template <typename Rows, int kRows>
size_t split_smem(const Rows& kv, int dh) {
  size_t bytes = sizeof(float) * kSplitWarps * kRows * (dh + 2);
  if constexpr (Rows::kStaged > 0)
    bytes += sizeof(int) * Rows::kStaged * kv.n_stage;
  return bytes;
}

template <typename Rows, int kRows, bool kChunk, int kPieces>
int launch_split(const Rows& kv, bool aligned, const void* q, const void* pos,
                 const void* win, ChunkRows chunk, float* pm, float* pl,
                 float* pa, int bhkv, int g, int dh, int lpk, int tile,
                 int tps, int n_splits, int streamed, float scale,
                 cudaStream_t stream) {
  const auto kernel =
      aligned ? key_split_kernel<Rows, kRows, true, kChunk, kPieces>
              : key_split_kernel<Rows, kRows, false, kChunk, kPieces>;
  const dim3 grid(bhkv, n_splits, (g + kRows - 1) / kRows);
  const size_t smem = split_smem<Rows, kRows>(kv, dh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kSplitThreads, smem, stream>>>(
      kv, static_cast<const float*>(q), static_cast<const int*>(pos),
      static_cast<const int*>(win), chunk, pm, pl, pa, g, dh, lpk, tile, tps,
      n_splits, streamed, scale);
  return static_cast<int>(cudaGetLastError());
}

// The key splits of a plan (kernels/flash_decode.py::contig_split_plan,
// paged_split_plan: `rows` query rows a block, 1 or 2; chunk_split_plan
// (kChunk): 2; lpk lanes a key row, `tile` keys a tile, tps tiles a split,
// n_splits splits), then their combine. A lane holds the plan's `pieces`
// 16-byte pieces of a row, ceil(dh / (lpk * V)): 1, or 2 for an f32 row
// of more than 32 pieces (lpk = 32; only f32 builds the 2-piece
// instances, so the bf16 ones are what they were). Refuses a plan that
// does not cover the kv.s keys with whole steps, or a row with whole
// pieces.
template <typename Rows, bool kChunk>
int launch_keys(const Rows& kv, bool aligned, const void* q, const void* pos,
                const void* win, ChunkRows chunk, float* pm, float* pl,
                float* pa, float* out, int b, int g, int dh, int rows,
                int lpk, int tile, int tps, int n_splits, int streamed,
                float scale, cudaStream_t stream) {
  constexpr int V = Vec<typename Rows::KV>::n;
  const int span = kSplitWarps * (lpk > 0 ? 32 / lpk : 0) * kStepKeys;
  const bool rows_ok = kChunk ? rows == 2 : rows == 1 || rows == 2;
  const int pieces = lpk * V >= dh ? 1 : 2;
  if (!rows_ok || lpk < 1 || lpk > 32 || (lpk & (lpk - 1)) != 0 ||
      pieces * lpk * V < dh || (pieces == 2 && (V != 4 || lpk != 32)) ||
      tile <= 0 || tile % span != 0 || tps < 1 || n_splits < 1 ||
      static_cast<int64_t>(n_splits) * tps * tile < kv.s)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bhkv = b * kv.hkv;
  const auto split = [&](auto rows_c, auto pieces_c) {
    return launch_split<Rows, decltype(rows_c)::value, kChunk,
                        decltype(pieces_c)::value>(
        kv, aligned, q, pos, win, chunk, pm, pl, pa, bhkv, g, dh, lpk, tile,
        tps, n_splits, streamed, scale, stream);
  };
  const auto by_rows = [&](auto pieces_c) {
    if constexpr (kChunk)
      return split(std::integral_constant<int, 2>(), pieces_c);
    else
      return rows == 1 ? split(std::integral_constant<int, 1>(), pieces_c)
                       : split(std::integral_constant<int, 2>(), pieces_c);
  };
  int err;
  if constexpr (V == 4)
    err = pieces == 2 ? by_rows(std::integral_constant<int, 2>())
                      : by_rows(std::integral_constant<int, 1>());
  else
    err = by_rows(std::integral_constant<int, 1>());
  if (err != 0) return err;
  return launch_combine(pm, pl, pa, out, bhkv, g, dh, n_splits, stream);
}

// 16-byte pieces can be loaded whole: rows of whole vectors, aligned pools
template <typename KV>
bool rows_aligned(int dh, const void* k, const void* v) {
  return (dh * sizeof(KV)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

template <typename KV>
int launch_contig(const void* k, const void* v, const void* q,
                  const void* pos, const void* win, float* pm, float* pl,
                  float* pa, float* out, int b, int s, int hkv, int g, int dh,
                  int rows, int lpk, int tile, int tps, int n_splits,
                  int streamed, float scale, cudaStream_t stream) {
  const ContigKV<KV> kv{static_cast<const KV*>(k), static_cast<const KV*>(v),
                        s, hkv};
  return launch_keys<ContigKV<KV>, false>(
      kv, rows_aligned<KV>(dh, k, v), q, pos, win, ChunkRows{nullptr, 1, g},
      pm, pl, pa, out, b, g, dh, rows, lpk, tile, tps, n_splits, streamed,
      scale, stream);
}

// K1 (kq == nullptr) or K6: the paged loaders, whose tiles must hold whole
// pages; each split stages at most tps * tile / page_size pages.
template <typename KV>
int launch_paged(const void* kp, const void* vp, const void* kq,
                 const void* vq, const void* ks, const void* vs,
                 const void* hw, const void* bt, const void* q,
                 const void* pos, const void* win, float* pm, float* pl,
                 float* pa, float* out, int b, int hkv, int g, int dh,
                 int page_size, int w, int rows, int lpk, int tile, int tps,
                 int n_splits, float scale, cudaStream_t stream) {
  if (page_size < 1 || w < 1 || tile <= 0 || tile % page_size != 0 ||
      tps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedKV<KV> fp{static_cast<const KV*>(kp), static_cast<const KV*>(vp),
                       static_cast<const int*>(bt), w * page_size, hkv, w,
                       page_size, tps * (tile / page_size), nullptr, 0};
  const bool aligned = rows_aligned<KV>(dh, kp, vp);
  const ChunkRows decode{nullptr, 1, g};
  if (kq == nullptr)
    return launch_keys<PagedKV<KV>, false>(fp, aligned, q, pos, win, decode,
                                           pm, pl, pa, out, b, g, dh, rows,
                                           lpk, tile, tps, n_splits, 0, scale,
                                           stream);
  // the codes beside a 16-byte piece: 8 bytes against bf16, 4 against f32
  constexpr uintptr_t code_bytes = Vec<KV>::n;
  const TieredPagedKV<KV> tiered{
      fp, static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(hw), nullptr, nullptr, 0};
  const bool codes_aligned =
      reinterpret_cast<uintptr_t>(kq) % code_bytes == 0 &&
      reinterpret_cast<uintptr_t>(vq) % code_bytes == 0;
  return launch_keys<TieredPagedKV<KV>, false>(
      tiered, aligned && codes_aligned, q, pos, win, decode, pm, pl, pa, out,
      b, g, dh, rows, lpk, tile, tps, n_splits, 0, scale, stream);
}

// K5: PagedKV's rows for chunk * group query rows a (request, KV head), row
// r at off[b] + r / group, over the fetch-union pos/win; tiles of whole
// pages as K1's.
template <typename KV>
int launch_paged_chunk(const void* kp, const void* vp, const void* bt,
                       const void* q, const void* pos, const void* win,
                       const void* off, float* pm, float* pl, float* pa,
                       float* out, int b, int hkv, int rows, int dh,
                       int page_size, int w, int chunk, int krows, int lpk,
                       int tile, int tps, int n_splits, float scale,
                       cudaStream_t stream) {
  if (page_size < 1 || w < 1 || tile <= 0 || tile % page_size != 0 ||
      tps < 1 || chunk < 2 || rows % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedKV<KV> fp{static_cast<const KV*>(kp), static_cast<const KV*>(vp),
                       static_cast<const int*>(bt), w * page_size, hkv, w,
                       page_size, tps * (tile / page_size), nullptr, 0};
  const ChunkRows rows_of{static_cast<const int*>(off), chunk, rows / chunk};
  return launch_keys<PagedKV<KV>, true>(
      fp, rows_aligned<KV>(dh, kp, vp), q, pos, win, rows_of, pm, pl, pa,
      out, b, rows, dh, krows, lpk, tile, tps, n_splits, 0, scale, stream);
}

// ---------------------------------------------------------------------------
// The latent key split (K8, K9, K10): absorbed-MLA attention on tensor
// cores
// ---------------------------------------------------------------------------
constexpr int kLatStep = 32;                 // keys a pipeline step
constexpr int kLatQSteps = 9;                // 16-wide k-steps a query quarter
constexpr int kLatNTiles = 16;               // 8-column value tiles a quarter
constexpr int kLatMaxDk = 4 * 16 * kLatQSteps;   // 576
constexpr int kLatMaxDv = 4 * 8 * kLatNTiles;    // 512
constexpr int kLatSStride = kLatStep + 8;    // floats a logit row in smem
constexpr int kLatMaxPages = 256;            // pages a split stages
constexpr int kLatRows = 32;                 // query rows a block: 2 m-tiles
constexpr int kLatWarps = 8;                 // 4 an m-tile
constexpr int kLatThreads = 32 * kLatWarps;
constexpr int kLatBarBytes = 64;             // the stages' mbarriers

// `bytes` (a multiple of 16) global -> shared in one bulk copy, completing
// as transaction bytes on mbarrier `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// orders this thread's shared-memory accesses before later bulk copies
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a * b, one m16n8k16 bf16 product with f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The three-part bf16 split of an f32 operand: x = x1 + x2 + x3 exactly.
// Each part keeps the top 8 significant bits of what is left (truncation:
// the upper 16 bits of the f32 word), so x1 holds bits 1-8 of x, x2 bits
// 9-16 and x3 the rest, at most 8 bits: every part is a bf16 value and
// both subtractions are exact.
__device__ __forceinline__ float bf16_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

// the three parts of the pair (lo, hi), each packed as a bf16x2 operand
// register (lo in the low half)
__device__ __forceinline__ void split3_pair(float lo, float hi, uint32_t& p1,
                                            uint32_t& p2, uint32_t& p3) {
  const float lo1 = bf16_trunc(lo), hi1 = bf16_trunc(hi);
  const float lo_r = lo - lo1, hi_r = hi - hi1;
  const float lo2 = bf16_trunc(lo_r), hi2 = bf16_trunc(hi_r);
  const float lo3 = lo_r - lo2, hi3 = hi_r - hi2;
  p1 = __byte_perm(__float_as_uint(lo1), __float_as_uint(hi1), 0x7632);
  p2 = __byte_perm(__float_as_uint(lo2), __float_as_uint(hi2), 0x7632);
  p3 = __byte_perm(__float_as_uint(lo3), __float_as_uint(hi3), 0x7632);
}

// d[d0 + i] += a * b[i] for G independent tiles, a split in three parts (a[k]:
// part k + 1). A bf16 b is exact (b[i][0] only): three products a tile. An
// f32 b is split too: the six products whose parts' ranks sum to at most
// 4; the three left out are below 2^-24 of the product. Smallest terms
// first; consecutive products go to different tiles, so none waits on the
// one before it.
template <bool kSplitB, int G, int N>
__device__ __forceinline__ void mma_split(float (&d)[N][4], int d0,
                                          const uint32_t (&a)[3][4],
                                          const uint32_t (&b)[G][3][2]) {
#pragma unroll
  for (int i = 0; i < G; ++i) mma_bf16(d[d0 + i], a[2], b[i][0][0], b[i][0][1]);
  if constexpr (kSplitB) {
#pragma unroll
    for (int i = 0; i < G; ++i) mma_bf16(d[d0 + i], a[1], b[i][1][0], b[i][1][1]);
#pragma unroll
    for (int i = 0; i < G; ++i) mma_bf16(d[d0 + i], a[0], b[i][2][0], b[i][2][1]);
  }
#pragma unroll
  for (int i = 0; i < G; ++i) mma_bf16(d[d0 + i], a[1], b[i][0][0], b[i][0][1]);
  if constexpr (kSplitB) {
#pragma unroll
    for (int i = 0; i < G; ++i) mma_bf16(d[d0 + i], a[0], b[i][1][0], b[i][1][1]);
  }
#pragma unroll
  for (int i = 0; i < G; ++i) mma_bf16(d[d0 + i], a[0], b[i][0][0], b[i][0][1]);
}

// B operands of QK^T for the 16 keys [kn, kn + 16) (two 8-key n-tiles) at
// k-step columns [d0, d0 + 16) of a staged latent tile: b = c^T, element
// (k = column, n = key). bf16: one ldmatrix of the key rows; f32: each
// lane's elements, split in three.
template <typename KV, int M>
__device__ __forceinline__ void qk_b_pair(const KV* tile, int ls, int kn,
                                          int d0, int lane,
                                          uint32_t (&b)[M][3][2], int i0) {
  if constexpr (sizeof(KV) == 2) {
    const int mi = lane >> 3, r = lane & 7;
    uint32_t x[4];
    ldsm_x4(x, tile + (kn + (mi >> 1) * 8 + r) * ls + d0 + (mi & 1) * 8);
    b[i0][0][0] = x[0];
    b[i0][0][1] = x[1];
    b[i0 + 1][0][0] = x[2];
    b[i0 + 1][0][1] = x[3];
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* row =
          reinterpret_cast<const float*>(tile) + (kn + nt * 8 + g) * ls + d0 +
          2 * t;
      const float2 lo = *reinterpret_cast<const float2*>(row);
      const float2 hi = *reinterpret_cast<const float2*>(row + 8);
      uint32_t(&bn)[3][2] = b[i0 + nt];
      split3_pair(lo.x, lo.y, bn[0][0], bn[1][0], bn[2][0]);
      split3_pair(hi.x, hi.y, bn[0][1], bn[1][1], bn[2][1]);
    }
  }
}

// B operands of PV for the value columns [n0, n0 + 16) (two n-tiles) at
// keys [k0, k0 + 16) of the same tile: element (k = key, n = column), the
// tile read transposed (ldmatrix .trans for bf16).
template <typename KV, int M>
__device__ __forceinline__ void pv_b_pair(const KV* tile, int ls, int k0,
                                          int n0, int lane,
                                          uint32_t (&b)[M][3][2], int i0) {
  if constexpr (sizeof(KV) == 2) {
    const int mi = lane >> 3, r = lane & 7;
    uint32_t x[4];
    ldsm_x4_trans(x, tile + (k0 + (mi & 1) * 8 + r) * ls + n0 + (mi >> 1) * 8);
    b[i0][0][0] = x[0];
    b[i0][0][1] = x[1];
    b[i0 + 1][0][0] = x[2];
    b[i0 + 1][0][1] = x[3];
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* col = reinterpret_cast<const float*>(tile) +
                         (k0 + 2 * t) * ls + n0 + nt * 8 + g;
      uint32_t(&bn)[3][2] = b[i0 + nt];
      split3_pair(col[0], col[ls], bn[0][0], bn[1][0], bn[2][0]);
      split3_pair(col[8 * ls], col[9 * ls], bn[0][1], bn[1][1], bn[2][1]);
    }
  }
}

// Row stride (elements) of a staged latent tile: the key width rounded up
// to whole k-steps (the extra columns zero), plus 8 elements, so the 8 rows
// an ldmatrix (or an f32 lane group) reads fall in distinct banks. A cold
// row's int8 codes are staged in the last dk bytes of its own row.
__host__ __device__ __forceinline__ int latent_row_stride(int dk) {
  return ((dk + 15) & ~15) + 8;
}

// steps in flight: four 37 KB bf16 tiles at DK = 576, two f32 ones
template <typename KV>
__host__ __device__ constexpr int latent_stages() {
  return sizeof(KV) == 2 ? 4 : 2;
}

// One block: request b = blockIdx.x, key split blockIdx.y, query rows
// [32 blockIdx.z, +32) of h; warps 0-3 own rows 0-15, warps 4-7 rows 16-31.
// The split's keys are the tiles [split * tps, +tps) of `tile` keys each
// (whole pages) that hold live keys [lo, hi] = [max(pos - win + 1, 0),
// min(pos, W * ps - 1)]; a split holding none writes m = -inf and exits.
// A live split stages its page ids (and, tiered, its cold pages' scales)
// once, then walks its live keys in steps of kLatStep absolute keys with
// the next latent_stages() - 1 steps in flight: warp 0 issues one bulk
// copy a live row (its latent in the pool dtype, or a cold row's codes
// into the row's last dk bytes), each step's bytes completing on that
// stage's mbarrier. A step's masked rows are zeroed and its cold rows
// turned into the pool dtype's values (codes * cs[page], rounded through
// the pool dtype) by one warp a row, before its products: QK^T by warp
// (m-tile, query quarter) over its quarter of the DK columns, the query's
// three parts in its registers for the whole call; the quarters' logits
// summed in order in shared memory; the step's online softmax by all
// threads (an 8-lane group a row, _softmax_tile's guards); PV by warp
// (m-tile, value quarter) into its quarter of the DV columns, the
// probabilities' three parts built from shared memory. With int8 codes
// (cq != nullptr: K10) a row of a block before first_hot = max(pos, 0) /
// ps - hw + 1 is cold; the products are the same code for either tier and
// either entry point, so K10 = K8 bit for bit when no row is cold. With
// kChunk (K9) the h rows are a chunk's C * H, pos and win its fetch-union
// scalars: [lo, hi] narrows to the keys the block's rows can see, and each
// row's softmax masks its own keys (logit -inf, p = 0), so a row with no
// valid key in a split leaves that split's m at -inf.
template <typename KV, bool kChunk>
__global__ void __launch_bounds__(kLatThreads, 1)
latent_split_kernel(const float* __restrict__ q, const KV* __restrict__ c,
                    const int8_t* __restrict__ cq,
                    const float* __restrict__ cs, const int* __restrict__ hw,
                    const int* __restrict__ pos_v,
                    const int* __restrict__ win_v,
                    const int* __restrict__ block_tables,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int h, int dk, int dv,
                    int ps, int w, int tile, int tps, int n_splits,
                    float scale, ChunkRows chunk) {
  constexpr int kRows = kLatRows;
  constexpr int kStages = latent_stages<KV>();
  constexpr bool kF32 = sizeof(KV) == 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dkp = (dk + 15) & ~15, ls = latent_row_stride(dk);
  const int code_off = ls * static_cast<int>(sizeof(KV)) - dk;   // bytes
  // codes arrive by bulk copy when a row of them is whole 16-byte pieces;
  // otherwise (narrow test widths) the prepare pass reads them itself
  const bool bulk_codes = dk % 16 == 0;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem_raw);   // [kStages]
  KV* s_tile = reinterpret_cast<KV*>(smem_raw + kLatBarBytes);
  float* s_part = reinterpret_cast<float*>(s_tile + kStages * kLatStep * ls);
  float* s_p = s_part + 4 * kRows * kLatSStride;  // [kRows][kLatSStride]
  float* s_m = s_p + kRows * kLatSStride;
  float* s_l = s_m + kRows;
  float* s_alpha = s_l + kRows;
  // a chunk row's keys [s_rng[r], s_rng[kRows + r]] (kChunk only)
  int* s_rng = reinterpret_cast<int*>(s_alpha + kRows);
  int* s_page = s_rng + (kChunk ? 2 * kRows : 0);
  float* s_scale = reinterpret_cast<float*>(s_page + tps * (tile / ps));

  const int b = blockIdx.x, split = blockIdx.y, r0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp >> 2, quarter = warp & 3;
  const int pos = pos_v[b], win = win_v[b];
  const int n_keys = w * ps;
  int lo = max(pos - win + 1, 0), hi = min(pos, n_keys - 1);
  // a chunk row i sits at off[b] + i / group with the window
  // win - (chunk - 1): the block's rows see [qp_first - row_win + 1,
  // qp_last] of [lo, hi]
  int base = 0, row_win = 0;
  if constexpr (kChunk) {
    base = chunk.off[b];
    row_win = win - (chunk.chunk - 1);
    lo = max(lo, base + r0 / chunk.group - row_win + 1);
    hi = min(hi, base + (min(r0 + kRows, h) - 1) / chunk.group);
  }
  const int64_t p0 = (static_cast<int64_t>(b) * n_splits + split) * h;

  const int n_tiles = (n_keys + tile - 1) / tile;
  const int t_begin = max(split * tps, lo / tile);
  const int t_end =
      lo <= hi ? min(min(split * tps + tps, n_tiles), hi / tile + 1) : t_begin;
  if (t_begin >= t_end) {
    for (int r = tid; r < kRows && r0 + r < h; r += kLatThreads)
      part_m[p0 + r0 + r] = -INFINITY;
    return;
  }
  // the split's live steps: absolute kLatStep-key steps holding a live key
  const int k_first = max(t_begin * tile, lo & ~(kLatStep - 1));
  const int k_end = min(t_end * tile, hi + 1);
  const int blk0 = max(k_first, lo) / ps;
  const int n_pg = (k_end - 1) / ps - blk0 + 1;
  // keys below cold_end are cold (none with cq == nullptr)
  const int cold_end =
      cq != nullptr ? max(max(pos, 0) / ps - hw[0] + 1, 0) * ps : 0;
  const int* bt = block_tables + static_cast<int64_t>(b) * w;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&s_bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < n_pg; i += kLatThreads) {
    const int page = bt[blk0 + i];
    s_page[i] = page;
    if ((blk0 + i) * ps < cold_end) s_scale[i] = cs[page];
  }
  for (int r = tid; r < kRows; r += kLatThreads) {
    s_m[r] = -INFINITY;
    s_l[r] = 0.f;
    if constexpr (kChunk) {
      const int qp = base + (r0 + r) / chunk.group;
      s_rng[r] = max(lo, qp - row_win + 1);
      s_rng[kRows + r] = min(hi, qp);
    }
  }
  // the k-step padding columns [dk, dkp) start zero (never copied)
  if (dkp > dk)
    for (int i = tid; i < kStages * kLatStep * (dkp - dk); i += kLatThreads) {
      const int row = i / (dkp - dk);
      s_tile[row * ls + dk + i % (dkp - dk)] = from_f32<KV>(0.f);
    }
  fence_proxy_async();
  __syncthreads();

  // (warp 0) step kb's live rows into tile buffer `stage`, lane j row j
  auto issue = [&](int kb, int stage) {
    const int kpos = kb + lane;
    const bool live = kpos >= lo && kpos <= hi;
    const bool cold = live && kpos < cold_end;
    uint32_t bytes = 0;
    const void* src = c;
    KV* dst = s_tile + (stage * kLatStep + lane) * ls;
    if (live && (!cold || bulk_codes)) {
      const int blk = kpos / ps;
      const int64_t row =
          static_cast<int64_t>(s_page[blk - blk0]) * ps + kpos - blk * ps;
      if (cold) {
        src = cq + row * dk;
        bytes = dk;
      } else {
        src = c + row * dk;
        bytes = dk * sizeof(KV);
      }
    }
    uint32_t total = bytes;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, off);
    if (lane == 0) mbar_expect_tx(&s_bar[stage], total);
    __syncwarp();
    if (bytes)
      bulk_g2s(cold ? reinterpret_cast<void*>(
                          reinterpret_cast<int8_t*>(dst) + code_off)
                    : dst,
               src, bytes, &s_bar[stage]);
  };
  if (warp == 0)
    for (int i = 0; i < kStages - 1; ++i)
      if (k_first + i * kLatStep < k_end) issue(k_first + i * kLatStep, i);

  // this warp's query rows and quarter: three bf16 parts of each f32 value,
  // in A-operand order, for the whole call
  const int ksteps = dkp / 16;
  const int kq = (ksteps + 3) / 4;
  const int ks0 = quarter * kq;
  const int my_ks = max(0, min(kq, ksteps - ks0));
  uint32_t qa[kLatQSteps][3][4];
  {
    const int row_a = r0 + mt * 16 + g, row_b = row_a + 8;
    const float* qa_row = q + (static_cast<int64_t>(b) * h + row_a) * dk;
    const float* qb_row = q + (static_cast<int64_t>(b) * h + row_b) * dk;
#pragma unroll
    for (int s = 0; s < kLatQSteps; ++s) {
      float2 v[4] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f),
                     make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
      if (s < my_ks) {
        const int d = (ks0 + s) * 16 + 2 * t;
        if (row_a < h && d < dk)
          v[0] = *reinterpret_cast<const float2*>(qa_row + d);
        if (row_b < h && d < dk)
          v[1] = *reinterpret_cast<const float2*>(qb_row + d);
        if (row_a < h && d + 8 < dk)
          v[2] = *reinterpret_cast<const float2*>(qa_row + d + 8);
        if (row_b < h && d + 8 < dk)
          v[3] = *reinterpret_cast<const float2*>(qb_row + d + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split3_pair(v[i].x, v[i].y, qa[s][0][i], qa[s][1][i], qa[s][2][i]);
    }
  }
  const int n_vt = dv / 8, vq = (n_vt + 3) / 4;
  const int vt0 = quarter * vq;
  const int my_vt = max(0, min(vq, n_vt - vt0));
  float oacc[kLatNTiles][4];
#pragma unroll
  for (int j = 0; j < kLatNTiles; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (int kb = k_first; kb < k_end; kb += kLatStep) {
    mbar_wait(&s_bar[stage], phase);
    __syncthreads();     // step kb landed; the step before it fully used
    if (warp == 0) {
      const int kn = kb + (kStages - 1) * kLatStep;
      if (kn < k_end) {
        fence_proxy_async();
        issue(kn, (stage + kStages - 1) % kStages);
      }
    }
    KV* tb = s_tile + stage * kLatStep * ls;
    if (kb < cold_end || kb < lo || kb + kLatStep - 1 > hi) {
      // one warp a row: a masked row zeroed, a cold row's codes times its
      // page's scale, rounded through the pool dtype (block-uniform branch)
      for (int j = warp; j < kLatStep; j += kLatWarps) {
        const int kpos = kb + j;
        KV* row = tb + j * ls;
        if (kpos < lo || kpos > hi) {
          for (int ch = lane; ch < dkp * static_cast<int>(sizeof(KV)) / 16;
               ch += 32)
            reinterpret_cast<uint4*>(row)[ch] = make_uint4(0u, 0u, 0u, 0u);
          continue;
        }
        if (kpos >= cold_end) continue;
        const float sc = s_scale[kpos / ps - blk0];
        const int8_t* codes = reinterpret_cast<const int8_t*>(row) + code_off;
        if (!bulk_codes) {
          const int blk = kpos / ps;
          codes = cq + (static_cast<int64_t>(s_page[blk - blk0]) * ps + kpos -
                        blk * ps) * dk;
        }
        constexpr int kCh = (kLatMaxDk / 8 + 31) / 32;
        uint2 cw[kCh];
#pragma unroll
        for (int i = 0; i < kCh; ++i) {
          const int ch = lane + 32 * i;
          if (ch < dk / 8)
            cw[i] = *reinterpret_cast<const uint2*>(codes + ch * 8);
        }
        __syncwarp();   // the values overwrite the codes
#pragma unroll
        for (int i = 0; i < kCh; ++i) {
          const int ch = lane + 32 * i;
          if (ch >= dk / 8) continue;
          uint4* out = reinterpret_cast<uint4*>(row + ch * 8);
          if constexpr (kF32) {
            out[0] = dequant<KV>(make_uint2(cw[i].x, 0u), sc, 4);
            out[1] = dequant<KV>(make_uint2(cw[i].y, 0u), sc, 4);
          } else {
            out[0] = dequant<KV>(cw[i], sc, 8);
          }
        }
        for (int d = dk + lane; d < dkp; d += 32) row[d] = from_f32<KV>(0.f);
      }
      fence_proxy_async();   // before later bulk copies into these rows
      __syncthreads();
    }

    // QK^T: this warp's m-tile against the step's keys over its quarter
    {
      float sacc[kLatStep / 8][4];
#pragma unroll
      for (int j = 0; j < kLatStep / 8; ++j)
        sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
      for (int s = 0; s < kLatQSteps; ++s) {
        if (s < my_ks) {
          const int d0 = (ks0 + s) * 16;
          uint32_t bb[kLatStep / 8][3][2];
#pragma unroll
          for (int np = 0; np < kLatStep / 16; ++np)
            qk_b_pair<KV>(tb, ls, np * 16, d0, lane, bb, 2 * np);
          mma_split<kF32>(sacc, 0, qa[s], bb);
        }
      }
      float* sp = s_part + (quarter * kRows + mt * 16 + g) * kLatSStride +
                  2 * t;
#pragma unroll
      for (int j = 0; j < kLatStep / 8; ++j) {
        *reinterpret_cast<float2*>(sp + j * 8) =
            make_float2(sacc[j][0], sacc[j][1]);
        *reinterpret_cast<float2*>(sp + 8 * kLatSStride + j * 8) =
            make_float2(sacc[j][2], sacc[j][3]);
      }
    }
    __syncthreads();

    // the step's online softmax: row tid / 8, keys 4 (tid % 8) .. + 3
    {
      const int row = tid >> 3, k0 = (tid & 7) * 4;
      // the keys this row sees: the block's, or a chunk row's own
      const int row_lo = kChunk ? s_rng[row] : lo;
      const int row_hi = kChunk ? s_rng[kRows + row] : hi;
      float lg[4], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row * kLatSStride + k0 + e;
        const float dot = ((s_part[i] + s_part[kRows * kLatSStride + i]) +
                           s_part[2 * kRows * kLatSStride + i]) +
                          s_part[3 * kRows * kLatSStride + i];
        const int kpos = kb + k0 + e;
        lg[e] = kpos >= row_lo && kpos <= row_hi ? dot * scale : -INFINITY;
        mx = fmax_nan(mx, lg[e]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmax_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = s_m[row];
      const float m_new = fmax_nan(m_prev, mx);
      // all-masked guards: exp(-inf - -inf) must contribute 0, not 1
      const float alpha = isfinite(m_prev) ? expf(m_prev - m_new) : 0.f;
      float p_sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kb + k0 + e;
        const float p =
            kpos >= row_lo && kpos <= row_hi ? expf(lg[e] - m_new) : 0.f;
        s_p[row * kLatSStride + k0 + e] = p;
        p_sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        p_sum += __shfl_xor_sync(0xffffffffu, p_sum, off);
      if ((tid & 7) == 0) {
        s_l[row] = s_l[row] * alpha + p_sum;
        s_m[row] = m_new;
        s_alpha[row] = alpha;
      }
    }
    __syncthreads();

    // PV: rescale, then add the step's values into this warp's columns,
    // four value tiles at a time
    {
      const float al_a = s_alpha[mt * 16 + g], al_b = s_alpha[mt * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < kLatNTiles; ++j) {
        oacc[j][0] *= al_a;
        oacc[j][1] *= al_a;
        oacc[j][2] *= al_b;
        oacc[j][3] *= al_b;
      }
#pragma unroll
      for (int ks = 0; ks < kLatStep / 16; ++ks) {
        uint32_t pa[3][4];
        const float* pr = s_p + (mt * 16 + g) * kLatSStride + ks * 16 + 2 * t;
        const float2 v0 = *reinterpret_cast<const float2*>(pr);
        const float2 v1 =
            *reinterpret_cast<const float2*>(pr + 8 * kLatSStride);
        const float2 v2 = *reinterpret_cast<const float2*>(pr + 8);
        const float2 v3 =
            *reinterpret_cast<const float2*>(pr + 8 * kLatSStride + 8);
        split3_pair(v0.x, v0.y, pa[0][0], pa[1][0], pa[2][0]);
        split3_pair(v1.x, v1.y, pa[0][1], pa[1][1], pa[2][1]);
        split3_pair(v2.x, v2.y, pa[0][2], pa[1][2], pa[2][2]);
        split3_pair(v3.x, v3.y, pa[0][3], pa[1][3], pa[2][3]);
#pragma unroll
        for (int j = 0; j < kLatNTiles; j += 4) {
          if (j < my_vt) {
            uint32_t bb[4][3][2];
            pv_b_pair<KV>(tb, ls, ks * 16, (vt0 + j) * 8, lane, bb, 0);
            pv_b_pair<KV>(tb, ls, ks * 16, (vt0 + j + 2) * 8, lane, bb, 2);
            mma_split<kF32>(oacc, j, pa, bb);
          }
        }
      }
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
    phase ^= stage == 0;
  }

  // the split's partial: m, l and the unnormalised accumulator
  for (int r = tid; r < kRows && r0 + r < h; r += kLatThreads) {
    part_m[p0 + r0 + r] = s_m[r];
    part_l[p0 + r0 + r] = s_l[r];
  }
  const int row_a = r0 + mt * 16 + g, row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < kLatNTiles; ++j) {
    if (j >= my_vt) break;
    const int col = (vt0 + j) * 8 + 2 * t;
    if (row_a < h)
      *reinterpret_cast<float2*>(part_acc + (p0 + row_a) * dv + col) =
          make_float2(oacc[j][0], oacc[j][1]);
    if (row_b < h)
      *reinterpret_cast<float2*>(part_acc + (p0 + row_b) * dv + col) =
          make_float2(oacc[j][2], oacc[j][3]);
  }
}

// Dynamic shared memory of a latent_split_kernel block: the tile ring, the
// quarters' logits and the probabilities, the row states (and a chunk's
// row ranges) and the staged pages and scales.
template <typename KV, bool kChunk>
size_t latent_smem(int dk, int n_stage) {
  return kLatBarBytes +
         sizeof(KV) * latent_stages<KV>() * kLatStep * latent_row_stride(dk) +
         sizeof(float) * (5 * kLatRows * kLatSStride + 3 * kLatRows) +
         (kChunk ? sizeof(int) * 2 * kLatRows : 0) +
         (sizeof(int) + sizeof(float)) * n_stage;
}

template <typename KV, bool kChunk>
cudaError_t latent_allow_smem(size_t smem) {
  return cudaFuncSetAttribute(latent_split_kernel<KV, kChunk>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The plan (kernels/flash_decode.py::latent_split_plan) the launcher takes:
// 32 query rows a block, tiles of whole pages and whole steps, splits
// covering the W * ps keys with no empty trailing split, at most
// kLatMaxPages pages a split; DK and DV whole 8-element pieces within the
// register budget, DV < DK.
bool latent_plan_ok(int h, int dk, int dv, int ps, int w, int rows, int tile,
                    int tps, int n_splits) {
  const int64_t keys = static_cast<int64_t>(w) * ps;
  return h > 0 && dk % 8 == 0 && dk <= kLatMaxDk && dv % 8 == 0 && dv > 0 &&
         dv < dk && dv <= kLatMaxDv && ps >= 1 && w >= 1 &&
         rows == kLatRows && tile > 0 && tile % kLatStep == 0 &&
         tile % ps == 0 && tps >= 1 && n_splits >= 1 &&
         static_cast<int64_t>(n_splits) * tps * tile >= keys &&
         static_cast<int64_t>(n_splits - 1) * tps * tile < keys &&
         tps * (tile / ps) <= kLatMaxPages;
}

// K8 (cq == nullptr), K10, or with kChunk K9 (h = C * H rows, chunk's
// rows): the latent splits of a plan, then K7's combine over g = h rows of
// dh = dv columns. Refuses any other plan, and pools whose rows are not
// 16-byte (latent) or 8-byte (codes) aligned.
template <typename KV, bool kChunk>
int launch_latent(const void* q, const void* c, const void* cq,
                  const void* cs, const void* hw, const void* pos,
                  const void* win, ChunkRows chunk, const void* bt,
                  float* pm, float* pl, float* pa, float* out, int b, int h,
                  int dk, int dv, int ps, int w, int rows, int tile, int tps,
                  int n_splits, float scale, cudaStream_t stream) {
  if (!latent_plan_ok(h, dk, dv, ps, w, rows, tile, tps, n_splits) ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cq) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = latent_smem<KV, kChunk>(dk, tps * (tile / ps));
  const cudaError_t e = latent_allow_smem<KV, kChunk>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(b, n_splits, (h + kLatRows - 1) / kLatRows);
  latent_split_kernel<KV, kChunk><<<grid, kLatThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(c),
      static_cast<const int8_t*>(cq), static_cast<const float*>(cs),
      static_cast<const int*>(hw), static_cast<const int*>(pos),
      static_cast<const int*>(win), static_cast<const int*>(bt), pm, pl, pa,
      h, dk, dv, ps, w, tile, tps, n_splits, scale, chunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_combine(pm, pl, pa, out, b, h, dv, n_splits, stream);
}

template <typename KV, bool kChunk>
int latent_occupancy(int dk, int n_stage, int* blocks_per_sm,
                     int* smem_per_block) {
  const size_t smem = latent_smem<KV, kChunk>(dk, n_stage);
  cudaError_t e = latent_allow_smem<KV, kChunk>(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, latent_split_kernel<KV, kChunk>, kLatThreads, smem);
  *smem_per_block = static_cast<int>(smem);
  return static_cast<int>(e);
}

}  // namespace

// K6: K1 over the fp/int8 tier pair with (P, Hkv) scales and a (1,) hot
// window in device memory; with kq == nullptr (int8 pools, scales and hot
// window unused), K1.
REPRO_EXPORT int flash_decode_paged_q8(
    const void* q, const void* kp, const void* vp, const void* kq,
    const void* vq, const void* ks, const void* vs, const void* hw,
    const void* pos, const void* win, const void* bt, void* part_m,
    void* part_l, void* part_acc, void* out, int b, int hkv, int g, int dh,
    int page_size, int w, int rows, int lpk, int tile, int tps, int n_splits,
    float scale, int is_bf16, void* stream) {
  if (b == 0 || hkv == 0 || g == 0) return 0;
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  float* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_paged<__nv_bfloat16>(
        kp, vp, kq, vq, ks, vs, hw, bt, q, pos, win, pm, pl, pa, o, b, hkv, g,
        dh, page_size, w, rows, lpk, tile, tps, n_splits, scale, st);
  return launch_paged<float>(kp, vp, kq, vq, ks, vs, hw, bt, q, pos, win, pm,
                             pl, pa, o, b, hkv, g, dh, page_size, w, rows,
                             lpk, tile, tps, n_splits, scale, st);
}

// K1: g query heads per KV head at one position each, through block
// tables (B, W), split over the W * page_size keys of a request's table as
// planned by the wrapper (kernels/flash_decode.py::paged_split_plan; the
// plan's arguments and scratch as flash_decode_contig's).
REPRO_EXPORT int flash_decode_paged(const void* q, const void* kp,
                                    const void* vp, const void* pos,
                                    const void* win, const void* bt,
                                    void* part_m, void* part_l,
                                    void* part_acc, void* out, int b, int hkv,
                                    int g, int dh, int page_size, int w,
                                    int rows, int lpk, int tile, int tps,
                                    int n_splits, float scale, int is_bf16,
                                    void* stream) {
  return flash_decode_paged_q8(q, kp, vp, nullptr, nullptr, nullptr, nullptr,
                               nullptr, pos, win, bt, part_m, part_l,
                               part_acc, out, b, hkv, g, dh, page_size, w,
                               rows, lpk, tile, tps, n_splits, scale, is_bf16,
                               stream);
}

// K5: rows = chunk * G query rows per KV head, row r at offset + r / G,
// through block tables (B, W), on K1's key split as planned by the wrapper
// (kernels/flash_decode.py::chunk_split_plan: krows query rows a block,
// lpk lanes a key row, `tile` keys a tile, tps tiles a split, n_splits
// splits); the partials part_m, part_l (B * Hkv, n_splits, rows) and
// part_acc (B * Hkv, n_splits, rows, dh) are the wrapper's scratch; pos and
// win are the chunk's fetch-union scalars.
REPRO_EXPORT int flash_chunk_paged(const void* q, const void* kp,
                                   const void* vp, const void* pos,
                                   const void* win, const void* off,
                                   const void* bt, void* part_m, void* part_l,
                                   void* part_acc, void* out, int b, int hkv,
                                   int rows, int dh, int page_size, int w,
                                   int chunk, int krows, int lpk, int tile,
                                   int tps, int n_splits, float scale,
                                   int is_bf16, void* stream) {
  if (b == 0 || hkv == 0 || rows == 0) return 0;
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  float* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_paged_chunk<__nv_bfloat16>(
        kp, vp, bt, q, pos, win, off, pm, pl, pa, o, b, hkv, rows, dh,
        page_size, w, chunk, krows, lpk, tile, tps, n_splits, scale, st);
  return launch_paged_chunk<float>(kp, vp, bt, q, pos, win, off, pm, pl, pa,
                                   o, b, hkv, rows, dh, page_size, w, chunk,
                                   krows, lpk, tile, tps, n_splits, scale,
                                   st);
}

// K7: g query heads per KV head at one position each, over a contiguous
// (B, S, Hkv, dh) cache, split over the key axis as planned by the wrapper
// (`rows` query rows a block, lpk lanes a key row, `tile` keys a tile, tps
// tiles a split, n_splits splits); the partials part_m, part_l (B * Hkv,
// n_splits, g) and part_acc (B * Hkv, n_splits, g, dh) are the wrapper's
// scratch. streamed = 1 walks every tile of [0, S).
REPRO_EXPORT int flash_decode_contig(const void* q, const void* k,
                                     const void* v, const void* pos,
                                     const void* win, void* part_m,
                                     void* part_l, void* part_acc, void* out,
                                     int b, int s, int hkv, int g, int dh,
                                     int rows, int lpk, int tile, int tps,
                                     int n_splits, float scale, int is_bf16,
                                     int streamed, void* stream) {
  if (b == 0 || hkv == 0 || g == 0 || s == 0) return 0;
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  float* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_contig<__nv_bfloat16>(k, v, q, pos, win, pm, pl, pa, o, b,
                                        s, hkv, g, dh, rows, lpk, tile, tps,
                                        n_splits, streamed, scale, st);
  return launch_contig<float>(k, v, q, pos, win, pm, pl, pa, o, b, s, hkv, g,
                              dh, rows, lpk, tile, tps, n_splits, streamed,
                              scale, st);
}

// K10: K8 over the fp/int8 latent tier pair with (P, 1) f32 scales and a
// (1,) hot window in device memory; with cq == nullptr (codes, scales and
// hot window unused), K8.
REPRO_EXPORT int flash_decode_paged_mla_q8(
    const void* q, const void* cp, const void* cq, const void* cs,
    const void* hw, const void* pos, const void* win, const void* bt,
    void* part_m, void* part_l, void* part_acc, void* out, int b, int h,
    int dk, int dv, int page_size, int w, int rows, int tile, int tps,
    int n_splits, float scale, int is_bf16, void* stream) {
  if (b == 0 || h == 0) return 0;
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  float* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const ChunkRows decode{nullptr, 1, h};
  if (is_bf16)
    return launch_latent<__nv_bfloat16, false>(
        q, cp, cq, cs, hw, pos, win, decode, bt, pm, pl, pa, o, b, h, dk, dv,
        page_size, w, rows, tile, tps, n_splits, scale, st);
  return launch_latent<float, false>(q, cp, cq, cs, hw, pos, win, decode, bt,
                                     pm, pl, pa, o, b, h, dk, dv, page_size,
                                     w, rows, tile, tps, n_splits, scale, st);
}

// K8: absorbed MLA decode, h query heads at one position each over one
// latent pool (P, page_size, dk), dv < dk value columns, split over the
// W * page_size keys of a request's table as planned by the wrapper
// (kernels/flash_decode.py::latent_split_plan: `rows` query rows a block,
// `tile` keys a tile, tps tiles a split, n_splits splits); the partials
// part_m, part_l (B, n_splits, h) and part_acc (B, n_splits, h, dv) are the
// wrapper's scratch, out the f32 (B, 1, h, dv) latent output.
REPRO_EXPORT int flash_decode_paged_mla(
    const void* q, const void* cp, const void* pos, const void* win,
    const void* bt, void* part_m, void* part_l, void* part_acc, void* out,
    int b, int h, int dk, int dv, int page_size, int w, int rows, int tile,
    int tps, int n_splits, float scale, int is_bf16, void* stream) {
  return flash_decode_paged_mla_q8(q, cp, nullptr, nullptr, nullptr, pos,
                                   win, bt, part_m, part_l, part_acc, out, b,
                                   h, dk, dv, page_size, w, rows, tile, tps,
                                   n_splits, scale, is_bf16, stream);
}

// K9: rows = chunk * H latent query rows, row r at offset + r / H, over
// one latent pool through block tables (B, W), on K8's latent split as
// planned by the wrapper (kernels/flash_decode.py::latent_split_plan for
// the C * H rows: krows query rows a block, `tile` keys a tile, tps tiles a
// split, n_splits splits); the partials part_m, part_l (B, n_splits, rows)
// and part_acc (B, n_splits, rows, dv) are the wrapper's scratch, out the
// f32 (B, 1, rows, dv) latent output; pos and win are the chunk's
// fetch-union scalars.
REPRO_EXPORT int flash_chunk_paged_mla(
    const void* q, const void* cp, const void* pos, const void* win,
    const void* off, const void* bt, void* part_m, void* part_l,
    void* part_acc, void* out, int b, int rows, int dk, int dv,
    int page_size, int w, int chunk, int krows, int tile, int tps,
    int n_splits, float scale, int is_bf16, void* stream) {
  if (b == 0 || rows == 0) return 0;
  if (chunk < 2 || rows % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  float* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  const ChunkRows rows_of{static_cast<const int*>(off), chunk, rows / chunk};
  if (is_bf16)
    return launch_latent<__nv_bfloat16, true>(
        q, cp, nullptr, nullptr, nullptr, pos, win, rows_of, bt, pm, pl, pa,
        o, b, rows, dk, dv, page_size, w, krows, tile, tps, n_splits, scale,
        st);
  return launch_latent<float, true>(q, cp, nullptr, nullptr, nullptr, pos,
                                    win, rows_of, bt, pm, pl, pa, o, b, rows,
                                    dk, dv, page_size, w, krows, tile, tps,
                                    n_splits, scale, st);
}

// Resident blocks per SM and dynamic shared memory per block, for the
// build report: kernel 8 or 10, the latent split of K8 or K10, or kernel
// 9, its chunk instance (K9), at `rows` = 32 query rows a block and
// n_stage staged pages.
REPRO_EXPORT int flash_mla_occupancy(int kernel, int rows, int dk, int dv,
                                     int is_bf16, int n_stage,
                                     int* blocks_per_sm, int* smem_per_block) {
  if ((kernel != 8 && kernel != 9 && kernel != 10) || rows != kLatRows ||
      dk % 8 != 0 || dk > kLatMaxDk)
    return static_cast<int>(cudaErrorInvalidValue);
  // one kernel serves K8 and K10: K10's cold codes are staged in their own
  // rows
  if (kernel == 9)
    return is_bf16 ? latent_occupancy<__nv_bfloat16, true>(
                         dk, n_stage, blocks_per_sm, smem_per_block)
                   : latent_occupancy<float, true>(dk, n_stage, blocks_per_sm,
                                                   smem_per_block);
  return is_bf16 ? latent_occupancy<__nv_bfloat16, false>(
                       dk, n_stage, blocks_per_sm, smem_per_block)
                 : latent_occupancy<float, false>(dk, n_stage, blocks_per_sm,
                                                  smem_per_block);
}
