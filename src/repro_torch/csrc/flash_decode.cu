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
//       row and each row re-derives its own validity inside the tile.
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
//       group = H and its fetch-union scalars.
//   K10 flash_decode_mla_paged_q8 (via flash_decode_paged_mla_q8): K8 over
//       the int8 latent tier; a cold page reads clq * cs[page] (ONE scale
//       per page: the latent is shared by every head) rounded through the
//       pool dtype, a hot page the fp pool, each page from one tier only.
// K1, K5, K6 and K7 return f32 (B, Hkv, rows, dh); K8, K9 and K10 return
// the f32 latent output (B, 1, rows, DV), never cast to the pool dtype (the
// caller applies W_uv).
//
// Which kernel serves which entry point:
//   key_split_kernel + split_combine_kernel (the key split, below), one
//   kernel body over three row loaders: K7 (flash_decode_contig, ContigKV),
//   K1 (flash_decode_paged, PagedKV) and K6 (flash_decode_paged_q8,
//   TieredPagedKV).
//   paged_attend_kernel (the shared paged body, below), one body over page
//   loaders: K5 (flash_chunk_paged, FpPages), K8 and K9
//   (flash_decode_paged_mla, flash_chunk_paged_mla, LatentPages) and K10
//   (flash_decode_paged_mla_q8, TieredLatentPages).
// Both copy the reference's online softmax; what differs between entry
// points of one body is the loader and the row positions (one position
// for decode, offset + r / group for a chunk).
//
// Bound on the H100: bytes for K1/K6/K7 (each live key is read once and
// used for 2*G*dh multiply-adds, far below the card's operations-per-byte
// balance); K5 reuses each key for C*G rows, still bytes-bound at the
// serving chunk sizes.
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
// row with 16-byte loads (8 bf16 or 4 f32 a lane) and reduce its dot
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
// once a page, each product rounded through the pool dtype
// (round_to_pool), so each page is read from one tier only. Its hot keys
// take PagedKV's loads and the same arithmetic, so K6 equals K1 bit for
// bit when the hot window covers the table.
//
// The shared paged body (K5, K8-K10): one block per (request, KV head)
// and, for K5, per group of at most kChunkRows query rows (grid.y), so
// shared memory stays bounded whatever C is. The block reads its own
// pos, window, offset, hot window and block-table row from device memory
// (this replaces scalar prefetch: no host sync) and loops only over the
// live pages [first, last], so dead keys are never read. One pass covers
// 32 keys, i.e. several pages at the serving page size of 8: K/V rows are
// gathered page by page into shared memory as f32; the query rows, the
// running max and sum and the unnormalised accumulator stay in shared
// memory for the whole loop. The online softmax copies `_softmax_tile`'s
// guards: alpha = 0 while the running max is still -inf, masked keys
// contribute p = 0, and the output is normalised once, acc / max(l,
// 1e-30), after the last pass. Idle slots (pos 0 against garbage page 0,
// always hot) read one page and stay finite. K5's fp tiles keep a row
// stride of dh, so its QK loop has the 32-way bank conflict the key split
// avoids; moving K5 to the split is later work.
//
// MLA at full width (H = 128, DK = 576, DV = 512) is no longer clearly
// bytes-bound: each latent value feeds 2*H*(DK + DV)/DK ~ 480 flops (in
// f32 accumulation), so the bound is the larger of the latent, q and out
// bytes over 3.35 TB/s and those flops over the card's rate. A row's
// query, accumulator, max and sum take 4.35 KB of shared memory in f32,
// so the H rows are split over grid.y in groups of kLatentRows (110 KB a
// block with the 32-key tile, two blocks an SM); each latent tile is then
// read by H / kLatentRows blocks per slot and the repeats come from L2.
// The staged latent tile has a row stride of DK + 1 floats, so the 32
// keys of a warp's dot products fall in 32 distinct banks.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kKeys = 32;       // keys per pass: one per lane in the softmax
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = 32;  // K5 query rows per block
constexpr int kLatentRows = 8;  // K8/K9/K10 query rows per block

// a dequantized value rounded through the pool dtype, as the reference's
// loader casts it (`.astype(k_ref.dtype).astype(f32)`)
template <typename KV>
__device__ __forceinline__ float round_to_pool(float x);
template <>
__device__ __forceinline__ float round_to_pool<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to_pool<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Page loader of the fp pools (K5).
template <typename KV>
struct FpPages {
  static constexpr bool kLatent = false;
  const KV* __restrict__ k;
  const KV* __restrict__ v;

  __device__ __forceinline__ void setup(int, int) {}
  // `off` is the element offset of (page, row, head, d) in a pool
  __device__ __forceinline__ void load(int64_t off, int, int, int, float& kk,
                                       float& vv) const {
    kk = to_f32(k[off]);
    vv = to_f32(v[off]);
  }
};

// Page loader of the fp latent pool (K8, K9): one value per (page, row,
// column), used as a key and, in its first DV columns, as a value.
template <typename KV>
struct LatentPages {
  static constexpr bool kLatent = true;
  const KV* __restrict__ c;

  __device__ __forceinline__ void setup(int, int) {}
  __device__ __forceinline__ float load(int64_t off, int, int) const {
    return to_f32(c[off]);
  }
};

// Page loader of the int8 latent tier (K10): one tier per page, one scale
// per page; block s is hot iff s > max(pos, 0) / page_size - hw, and a cold
// value is rounded through the pool dtype (round_to_pool).
template <typename KV>
struct TieredLatentPages {
  static constexpr bool kLatent = true;
  const KV* __restrict__ c;
  const int8_t* __restrict__ cq;
  const float* __restrict__ cs;   // (P, 1)
  const int* __restrict__ hw;
  int first_hot;

  __device__ __forceinline__ void setup(int pos, int page_size) {
    first_hot = max(pos, 0) / page_size - hw[0] + 1;
  }
  __device__ __forceinline__ float load(int64_t off, int page,
                                        int blk) const {
    if (blk >= first_hot) return to_f32(c[off]);
    return round_to_pool<KV>(static_cast<float>(cq[off]) * cs[page]);
  }
};

// One block: request b = blockIdx.x / hkv, KV head h = blockIdx.x % hkv,
// query rows [blockIdx.y * rpb, +rpb) of `rows`. Row r sits at position
// base + r / group, base = offset[b] (chunk) or pos[b] (decode, group =
// rows), and attends kpos in (qp - (win - (chunk - 1)), qp].
template <typename Pages>
__global__ void __launch_bounds__(kThreads)
paged_attend_kernel(Pages pages, const float* __restrict__ q,
                    const int* __restrict__ pos_v,
                    const int* __restrict__ win_v,
                    const int* __restrict__ off_v,
                    const int* __restrict__ block_tables,
                    float* __restrict__ out, int hkv, int rows, int rpb,
                    int dk, int dv, int ks, int page_size, int w, int chunk,
                    int group, float scale) {
  // dk: key (and query) width; dv: value width; ks: row stride of the
  // staged key tile. Fp pools: dk = dv = ks = dh, separate K and V tiles.
  // Latent pools: the value tile is the first dv columns of the key tile.
  extern __shared__ float smem[];
  float* s_q = smem;                   // rpb * dk
  float* s_acc = s_q + rpb * dk;       // rpb * dv
  float* s_k = s_acc + rpb * dv;       // kKeys * ks
  float* s_v = Pages::kLatent ? s_k : s_k + kKeys * ks;   // kKeys * dv
  const int vs = Pages::kLatent ? ks : dv;                // its row stride
  float* s_p = s_k + kKeys * ks + (Pages::kLatent ? 0 : kKeys * dv);
  float* s_m = s_p + rpb * kKeys;      // rpb
  float* s_l = s_m + rpb;              // rpb
  float* s_alpha = s_l + rpb;          // rpb

  const int b = blockIdx.x / hkv, h = blockIdx.x % hkv;
  const int r0 = blockIdx.y * rpb;
  const int nr = min(rpb, rows - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = pos_v[b], win = win_v[b];
  const int base = off_v != nullptr ? off_v[b] : pos;
  const int row_win = win - (chunk - 1);
  const int* bt = block_tables + static_cast<int64_t>(b) * w;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows + r0;
  const int64_t qo = row0 * dk, oo = row0 * dv;
  Pages pg = pages;
  pg.setup(pos, page_size);

  for (int i = tid; i < nr * dk; i += kThreads) s_q[i] = q[qo + i];
  for (int i = tid; i < nr * dv; i += kThreads) s_acc[i] = 0.f;
  for (int i = tid; i < nr; i += kThreads) {
    s_m[i] = -INFINITY;
    s_l[i] = 0.f;
  }
  __syncthreads();

  // _live_block_range of the (fetch-union) scalars: [first, last] blocks
  // holding any valid key
  const int first = max(pos - win + 1, 0) / page_size;
  const int last = min(max(pos, 0) / page_size, w - 1);
  const int k_begin = first * page_size;
  const int k_end = (last + 1) * page_size;

  for (int t0 = k_begin; t0 < k_end; t0 += kKeys) {
    for (int i = tid; i < kKeys * dk; i += kThreads) {
      const int j = i / dk, d = i - j * dk;
      const int kpos = t0 + j;
      float kk = 0.f, vv = 0.f;
      if (kpos < k_end) {
        const int blk = kpos / page_size;
        const int page = bt[blk];
        const int64_t off =
            ((static_cast<int64_t>(page) * page_size + kpos % page_size) *
                 hkv + h) * dk + d;
        if constexpr (Pages::kLatent)
          kk = pg.load(off, page, blk);
        else
          pg.load(off, page, blk, h, kk, vv);
      }
      s_k[j * ks + d] = kk;
      if constexpr (!Pages::kLatent) s_v[i] = vv;
    }
    __syncthreads();
    for (int i = tid; i < nr * kKeys; i += kThreads) {
      const int gi = i / kKeys, j = i - gi * kKeys;
      const int kpos = t0 + j;
      const int qp = base + (r0 + gi) / group;
      const bool valid = kpos < k_end && kpos <= qp && kpos > qp - row_win;
      float dot = 0.f;
      if (valid)
        for (int d = 0; d < dk; ++d) dot += s_q[gi * dk + d] * s_k[j * ks + d];
      s_p[i] = valid ? dot * scale : -INFINITY;
    }
    __syncthreads();
    for (int gi = warp; gi < nr; gi += kWarps) {
      const int kpos = t0 + lane;
      const int qp = base + (r0 + gi) / group;
      const bool valid = kpos < k_end && kpos <= qp && kpos > qp - row_win;
      const float logit = s_p[gi * kKeys + lane];
      const float m_prev = s_m[gi];
      const float m_new = fmaxf(m_prev, warp_max(logit));
      // all-masked guards: exp(-inf - -inf) must contribute 0, not 1
      const float alpha = isfinite(m_prev) ? expf(m_prev - m_new) : 0.f;
      const float p = valid ? expf(logit - m_new) : 0.f;
      const float p_sum = warp_sum(p);
      s_p[gi * kKeys + lane] = p;
      __syncwarp();
      if (lane == 0) {
        s_l[gi] = s_l[gi] * alpha + p_sum;
        s_m[gi] = m_new;
        s_alpha[gi] = alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * dv; i += kThreads) {
      const int gi = i / dv, d = i - gi * dv;
      float pv = 0.f;
      for (int j = 0; j < kKeys; ++j)
        pv += s_p[gi * kKeys + j] * s_v[j * vs + d];
      s_acc[i] = s_acc[i] * s_alpha[gi] + pv;
    }
    __syncthreads();
  }

  // the one output conversion: normalise once, after the full reduction
  for (int i = tid; i < nr * dv; i += kThreads)
    out[oo + i] = s_acc[i] / fmaxf(s_l[i / dv], 1e-30f);
}

// Dynamic shared memory of one block (see the kernel's carve-up).
template <typename Pages>
size_t smem_bytes(int rpb, int dk, int dv, int ks) {
  return sizeof(float) * (rpb * dk + rpb * dv + kKeys * ks +
                          (Pages::kLatent ? 0 : kKeys * dv) + rpb * kKeys +
                          3 * rpb);
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename Pages>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(paged_attend_kernel<Pages>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename Pages>
int launch(const Pages& pages, const void* q, const void* pos,
           const void* win, const void* off, const void* bt, void* out,
           int b, int hkv, int rows, int rpb, int dk, int dv, int ks,
           int page_size, int w, int chunk, float scale, void* stream) {
  const size_t smem = smem_bytes<Pages>(rpb, dk, dv, ks);
  const cudaError_t e = allow_smem<Pages>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(b * hkv, (rows + rpb - 1) / rpb);
  paged_attend_kernel<Pages><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      pages, static_cast<const float*>(q), static_cast<const int*>(pos),
      static_cast<const int*>(win), static_cast<const int*>(off),
      static_cast<const int*>(bt), static_cast<float*>(out), hkv, rows, rpb,
      dk, dv, ks, page_size, w, chunk, rows / chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

// GQA pools: key, value and stride widths are all dh.
template <typename Pages>
int launch_gqa(const Pages& pages, const void* q, const void* pos,
               const void* win, const void* off, const void* bt, void* out,
               int b, int hkv, int rows, int rpb, int dh, int page_size,
               int w, int chunk, float scale, void* stream) {
  return launch(pages, q, pos, win, off, bt, out, b, hkv, rows, rpb, dh, dh,
                dh, page_size, w, chunk, scale, stream);
}

// Latent pools: one KV head, dk-wide keys, dv-wide values, the staged
// tile padded to a dk + 1 stride.
template <typename Pages>
int launch_mla(const Pages& pages, const void* q, const void* pos,
               const void* win, const void* off, const void* bt, void* out,
               int b, int rows, int dk, int dv, int page_size, int w,
               int chunk, float scale, void* stream) {
  if (dv <= 0 || dv >= dk) return static_cast<int>(cudaErrorInvalidValue);
  const int rpb = rows < kLatentRows ? rows : kLatentRows;
  return launch(pages, q, pos, win, off, bt, out, b, 1, rows, rpb, dk, dv,
                dk + 1, page_size, w, chunk, scale, stream);
}

template <typename KV>
FpPages<KV> fp_pages(const void* kp, const void* vp) {
  return FpPages<KV>{static_cast<const KV*>(kp), static_cast<const KV*>(vp)};
}

template <typename KV>
LatentPages<KV> latent_pages(const void* c) {
  return LatentPages<KV>{static_cast<const KV*>(c)};
}

template <typename KV>
TieredLatentPages<KV> tiered_latent_pages(const void* c, const void* cq,
                                          const void* cs, const void* hw) {
  return TieredLatentPages<KV>{static_cast<const KV*>(c),
                               static_cast<const int8_t*>(cq),
                               static_cast<const float*>(cs),
                               static_cast<const int*>(hw), 0};
}

// ---------------------------------------------------------------------------
// The key split (K1, K6, K7): the key axis split over blocks
// ---------------------------------------------------------------------------
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kStepKeys = 4;     // keys a lane group takes per update

// elements of KV in one 16-byte load
template <typename KV>
struct Vec {
  static constexpr int n = 16 / sizeof(KV);
};

// up to 16 bytes of a row from p: `n_valid` elements (<= 0: none, zeros);
// the aligned form needs a 16-byte aligned p and n_valid <= 0 or >= a vector
template <typename KV, bool kAligned>
__device__ __forceinline__ uint4 load_raw(const KV* p, int n_valid) {
  if (n_valid <= 0) return make_uint4(0, 0, 0, 0);
  if (kAligned) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0, 0, 0, 0};
  if constexpr (sizeof(KV) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n_valid) w[e] = __ldg(reinterpret_cast<const unsigned int*>(p) + e);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n_valid)
        w[e / 2] |= static_cast<uint32_t>(__ldg(
                        reinterpret_cast<const unsigned short*>(p) + e))
                    << (16 * (e % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

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
// through the pool dtype (round_to_pool), packed as the pool dtype's bits:
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

// The pieces at d0 of the key and value rows of keys k0 + u * pass,
// u < kStepKeys; a masked key (outside [lo, hi]) is not read: its p is 0
// and its value row stays 0. A cold key's codes wait in kr/vr for
// dequant_step.
template <typename Rows, bool kAligned>
__device__ __forceinline__ void fetch_step(
    const Rows& kv, int b, int h, int dh, int d0, int lo, int hi, int k0,
    int pass, uint4 (&kr)[kStepKeys], uint4 (&vr)[kStepKeys],
    bool (&ok)[kStepKeys], bool (&cold)[kStepKeys], float (&kc)[kStepKeys],
    float (&vc)[kStepKeys]) {
#pragma unroll
  for (int u = 0; u < kStepKeys; ++u) {
    const int kpos = k0 + u * pass;
    ok[u] = kpos >= lo && kpos <= hi;
    cold[u] = kv.template fetch<kAligned>(b, kpos, h, dh, d0, ok[u], kr[u],
                                          vr[u], kc[u], vc[u]);
  }
}

// A step's cold codes to the pool dtype's bits (tiered loaders only), once
// all its loads are in flight: the step's compute then reads every key as
// K1 reads it, in one branch-free block, so the compiler makes the same
// arithmetic of both and K6 over hot pages equals K1 bit for bit.
template <typename Rows>
__device__ __forceinline__ void dequant_step(uint4 (&kr)[kStepKeys],
                                             uint4 (&vr)[kStepKeys],
                                             const bool (&cold)[kStepKeys],
                                             const float (&kc)[kStepKeys],
                                             const float (&vc)[kStepKeys],
                                             int n_valid) {
  if constexpr (Rows::kTiered) {
    using KV = typename Rows::KV;
#pragma unroll
    for (int u = 0; u < kStepKeys; ++u)
      if (cold[u]) {
        kr[u] = dequant<KV>(make_uint2(kr[u].x, kr[u].y), kc[u], n_valid);
        vr[u] = dequant<KV>(make_uint2(vr[u].x, vr[u].y), vc[u], n_valid);
      }
  }
}

__device__ __forceinline__ void unpack(const uint4 u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);          // bf16 -> f32, exact
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The weight of an online-softmax state whose max is m in a merge whose
// max is m_new, with _softmax_tile's guard: a state whose max is -inf
// weighs 0 (and its sum and accumulator are not read).
__device__ __forceinline__ float merge_weight(float m, float m_new) {
  return m == -INFINITY ? 0.f : expf(m - m_new);
}

// One block: (b, h) = blockIdx.x, key split blockIdx.y, query rows
// [blockIdx.z * kRows, +kRows) of g. Keys are cut into absolute tiles of
// `tile` keys, `tiles_per_split` of them a split. The live keys are
// [lo, hi] = [max(pos - win + 1, 0), min(pos, S - 1)] (S = kv.s); unless
// `streamed`, only the tiles holding them are visited, and a split holding
// none writes m = -inf and exits. A staging loader then stages the split's
// live pages (one barrier). Lane group `grp` (lpk lanes, 16 bytes of a row
// each) owns key kb + u * (kSplitWarps * 32 / lpk) + warp * (32 / lpk) +
// grp of each step kb and keeps its own online-softmax state over them
// (no block barrier in the key loop); the groups merge by shuffles, then
// the warps through shared memory, in a fixed order. The split's partial
// (m, l, unnormalised acc) goes to part_*.
template <typename Rows, int kRows, bool kAligned>
__global__ void __launch_bounds__(kSplitThreads)
key_split_kernel(Rows loader, const float* __restrict__ q,
                 const int* __restrict__ pos_v, const int* __restrict__ win_v,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, int g, int dh, int lpk,
                 int tile, int tiles_per_split, int n_splits, int streamed,
                 float scale) {
  constexpr int V = Vec<typename Rows::KV>::n;
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
  const int pos = pos_v[b], win = win_v[b];
  const int lo = max(pos - win + 1, 0), hi = min(pos, kv.s - 1);
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
  uint4 kr[kStepKeys], vr[kStepKeys];
  bool ok[kStepKeys], cold[kStepKeys];
  float kc[kStepKeys], vc[kStepKeys];
  // in flight while the query is read; later steps' loads overlap other
  // blocks' work
  fetch_step<Rows, kAligned>(kv, b, h, dh, d0, lo, hi, k_first + key0, pass,
                             kr, vr, ok, cold, kc, vc);

  float qv[kRows][V], acc[kRows][V], m_run[kRows], l_run[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float* qr = q + (static_cast<int64_t>(bh) * g + r0 + r) * dh;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      qv[r][e] = (r < nr && d0 + e < dh) ? qr[d0 + e] : 0.f;
      acc[r][e] = 0.f;
    }
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
  }

  for (int kb = k_first; kb < k_last; kb += span) {
    if (kb != k_first)
      fetch_step<Rows, kAligned>(kv, b, h, dh, d0, lo, hi, kb + key0, pass,
                                 kr, vr, ok, cold, kc, vc);
    dequant_step<Rows>(kr, vr, cold, kc, vc, dh - d0);
    float logit[kRows][kStepKeys];
#pragma unroll
    for (int u = 0; u < kStepKeys; ++u) {
      float kf[V];
      unpack(kr[u], kf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) dot += qv[r][e] * kf[e];
        for (int off = 1; off < lpk; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        logit[r][u] = ok[u] ? dot * scale : -INFINITY;
      }
    }
    // the online update: logit[r][u] becomes p, acc is rescaled, then the
    // step's values are added key by key
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float mx = logit[r][0];
#pragma unroll
      for (int u = 1; u < kStepKeys; ++u) mx = fmaxf(mx, logit[r][u]);
      const float m_new = fmaxf(m_run[r], mx);
      // all-masked guards: exp(-inf - -inf) must contribute 0, not 1
      const float alpha = isfinite(m_run[r]) ? expf(m_run[r] - m_new) : 0.f;
      float p_sum = 0.f;
#pragma unroll
      for (int u = 0; u < kStepKeys; ++u) {
        logit[r][u] = ok[u] ? expf(logit[r][u] - m_new) : 0.f;
        p_sum += logit[r][u];
      }
      l_run[r] = l_run[r] * alpha + p_sum;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] *= alpha;
      m_run[r] = m_new;
    }
#pragma unroll
    for (int u = 0; u < kStepKeys; ++u) {
      float vf[V];
      unpack(vr[u], vf);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] += logit[r][u] * vf[e];
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
      const float m_new = fmaxf(m_run[r], mo);
      const float wa = merge_weight(m_run[r], m_new);
      const float wb = merge_weight(mo, m_new);
      l_run[r] = l_run[r] * wa + lo_ * wb;
#pragma unroll
      for (int e = 0; e < V; ++e) {
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
      for (int e = 0; e < V; ++e)
        if (d0 + e < dh) s_acc[(warp * kRows + r) * dh + d0 + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * dh; i += kSplitThreads) {
    const int r = i / dh, d = i - r * dh;
    float m_all = -INFINITY;
    for (int w = 0; w < kSplitWarps; ++w)
      m_all = fmaxf(m_all, s_m[w * kRows + r]);
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
// (a split whose m is -inf weighs 0 and is not read further) and normalise
// once, acc / max(l, 1e-30). Block (bh, y) writes outputs [128 y, +128) of
// the (g, dh) rows of bh, one a thread.
__global__ void __launch_bounds__(kSplitThreads)
split_combine_kernel(const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc,
                     float* __restrict__ out, int g, int dh, int n_splits) {
  extern __shared__ float s_ml[];   // the (b, h)'s m, then l: n_splits * g
  const int n = n_splits * g;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kSplitThreads) {
    s_ml[i] = part_m[base + i];
    s_ml[n + i] = part_l[base + i];
  }
  __syncthreads();
  constexpr int kBatch = 8;         // splits whose accumulators load at once
  const int i = blockIdx.y * kSplitThreads + threadIdx.x;
  if (i < g * dh) {
    const int r = i / dh, d = i - r * dh;
    float m_all = -INFINITY;
    for (int s = 0; s < n_splits; ++s) m_all = fmaxf(m_all, s_ml[s * g + r]);
    float l_all = 0.f, a_all = 0.f;
    for (int s0 = 0; s0 < n_splits; s0 += kBatch) {
      float a[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int s = s0 + j;
        a[j] = s < n_splits && s_ml[s * g + r] != -INFINITY
                   ? part_acc[(base + s * g + r) * dh + d]
                   : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int s = s0 + j;
        if (s >= n_splits) break;
        const float ms = s_ml[s * g + r];
        if (ms == -INFINITY) continue;
        const float wt = expf(ms - m_all);
        l_all += s_ml[n + s * g + r] * wt;
        a_all += a[j] * wt;
      }
    }
    out[(base / n_splits + r) * dh + d] = a_all / fmaxf(l_all, 1e-30f);
  }
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

template <typename Rows, int kRows>
int launch_split(const Rows& kv, bool aligned, const void* q, const void* pos,
                 const void* win, float* pm, float* pl, float* pa, int bhkv,
                 int g, int dh, int lpk, int tile, int tps, int n_splits,
                 int streamed, float scale, cudaStream_t stream) {
  const auto kernel = aligned ? key_split_kernel<Rows, kRows, true>
                              : key_split_kernel<Rows, kRows, false>;
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
      static_cast<const int*>(win), pm, pl, pa, g, dh, lpk, tile, tps,
      n_splits, streamed, scale);
  return static_cast<int>(cudaGetLastError());
}

// The key splits of a plan (kernels/flash_decode.py::contig_split_plan,
// paged_split_plan: `rows` query rows a block, lpk lanes a key row, `tile`
// keys a tile, tps tiles a split, n_splits splits), then their combine.
// Refuses a plan that does not cover the kv.s keys with whole steps, every
// lane group owning one 16-byte piece of a row.
template <typename Rows>
int launch_keys(const Rows& kv, bool aligned, const void* q, const void* pos,
                const void* win, float* pm, float* pl, float* pa, float* out,
                int b, int g, int dh, int rows, int lpk, int tile, int tps,
                int n_splits, int streamed, float scale,
                cudaStream_t stream) {
  constexpr int V = Vec<typename Rows::KV>::n;
  const int span = kSplitWarps * (lpk > 0 ? 32 / lpk : 0) * kStepKeys;
  if ((rows != 1 && rows != 2) || lpk < 1 || lpk > 32 ||
      (lpk & (lpk - 1)) != 0 || lpk * V < dh ||
      tile <= 0 || tile % span != 0 || tps < 1 || n_splits < 1 ||
      static_cast<int64_t>(n_splits) * tps * tile < kv.s)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bhkv = b * kv.hkv;
  const int err =
      rows == 1 ? launch_split<Rows, 1>(kv, aligned, q, pos, win, pm, pl, pa,
                                        bhkv, g, dh, lpk, tile, tps, n_splits,
                                        streamed, scale, stream)
                : launch_split<Rows, 2>(kv, aligned, q, pos, win, pm, pl, pa,
                                        bhkv, g, dh, lpk, tile, tps, n_splits,
                                        streamed, scale, stream);
  if (err != 0) return err;
  const size_t smem = sizeof(float) * 2 * n_splits * g;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(bhkv, (g * dh + kSplitThreads - 1) / kSplitThreads);
  split_combine_kernel<<<grid, kSplitThreads, smem, stream>>>(
      pm, pl, pa, out, g, dh, n_splits);
  return static_cast<int>(cudaGetLastError());
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
  return launch_keys(kv, rows_aligned<KV>(dh, k, v), q, pos, win, pm, pl, pa,
                     out, b, g, dh, rows, lpk, tile, tps, n_splits, streamed,
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
  if (kq == nullptr)
    return launch_keys(fp, aligned, q, pos, win, pm, pl, pa, out, b, g, dh,
                       rows, lpk, tile, tps, n_splits, 0, scale, stream);
  // the codes beside a 16-byte piece: 8 bytes against bf16, 4 against f32
  constexpr uintptr_t code_bytes = Vec<KV>::n;
  const TieredPagedKV<KV> tiered{
      fp, static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(hw), nullptr, nullptr, 0};
  const bool codes_aligned =
      reinterpret_cast<uintptr_t>(kq) % code_bytes == 0 &&
      reinterpret_cast<uintptr_t>(vq) % code_bytes == 0;
  return launch_keys(tiered, aligned && codes_aligned, q, pos, win, pm, pl,
                     pa, out, b, g, dh, rows, lpk, tile, tps, n_splits, 0,
                     scale, stream);
}

template <typename Pages>
int occupancy(int rows, int dk, int dv, int* blocks_per_sm,
              int* smem_per_block) {
  const int rpb = rows < kLatentRows ? rows : kLatentRows;
  const size_t smem = smem_bytes<Pages>(rpb, dk, dv, dk + 1);
  cudaError_t e = allow_smem<Pages>(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, paged_attend_kernel<Pages>, kThreads, smem);
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

// K5: rows = chunk * G query rows per KV head, row r at offset + r / G.
REPRO_EXPORT int flash_chunk_paged(const void* q, const void* kp,
                                   const void* vp, const void* pos,
                                   const void* win, const void* off,
                                   const void* bt, void* out, int b, int hkv,
                                   int rows, int dh, int page_size, int w,
                                   int chunk, float scale, int is_bf16,
                                   void* stream) {
  if (b == 0 || hkv == 0 || rows == 0) return 0;
  if (chunk < 1 || rows % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpb = rows < kChunkRows ? rows : kChunkRows;
  if (is_bf16)
    return launch_gqa(fp_pages<__nv_bfloat16>(kp, vp), q, pos, win, off, bt,
                      out, b, hkv, rows, rpb, dh, page_size, w, chunk, scale,
                      stream);
  return launch_gqa(fp_pages<float>(kp, vp), q, pos, win, off, bt, out, b,
                    hkv, rows, rpb, dh, page_size, w, chunk, scale, stream);
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

// K8: absorbed MLA decode, h query heads over one latent pool.
REPRO_EXPORT int flash_decode_paged_mla(const void* q, const void* cp,
                                        const void* pos, const void* win,
                                        const void* bt, void* out, int b,
                                        int h, int dk, int dv, int page_size,
                                        int w, float scale, int is_bf16,
                                        void* stream) {
  if (b == 0 || h == 0) return 0;
  if (is_bf16)
    return launch_mla(latent_pages<__nv_bfloat16>(cp), q, pos, win, nullptr,
                      bt, out, b, h, dk, dv, page_size, w, 1, scale, stream);
  return launch_mla(latent_pages<float>(cp), q, pos, win, nullptr, bt, out, b,
                    h, dk, dv, page_size, w, 1, scale, stream);
}

// K9: rows = chunk * H latent query rows, row r at offset + r / H.
REPRO_EXPORT int flash_chunk_paged_mla(const void* q, const void* cp,
                                       const void* pos, const void* win,
                                       const void* off, const void* bt,
                                       void* out, int b, int rows, int dk,
                                       int dv, int page_size, int w,
                                       int chunk, float scale, int is_bf16,
                                       void* stream) {
  if (b == 0 || rows == 0) return 0;
  if (chunk < 1 || rows % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch_mla(latent_pages<__nv_bfloat16>(cp), q, pos, win, off, bt,
                      out, b, rows, dk, dv, page_size, w, chunk, scale,
                      stream);
  return launch_mla(latent_pages<float>(cp), q, pos, win, off, bt, out, b,
                    rows, dk, dv, page_size, w, chunk, scale, stream);
}

// K10: K8 over the fp/int8 latent tier pair with (P, 1) scales and a (1,)
// hot window in device memory.
REPRO_EXPORT int flash_decode_paged_mla_q8(
    const void* q, const void* cp, const void* cq, const void* cs,
    const void* hw, const void* pos, const void* win, const void* bt,
    void* out, int b, int h, int dk, int dv, int page_size, int w,
    float scale, int is_bf16, void* stream) {
  if (b == 0 || h == 0) return 0;
  if (is_bf16)
    return launch_mla(tiered_latent_pages<__nv_bfloat16>(cp, cq, cs, hw), q,
                      pos, win, nullptr, bt, out, b, h, dk, dv, page_size, w,
                      1, scale, stream);
  return launch_mla(tiered_latent_pages<float>(cp, cq, cs, hw), q, pos, win,
                    nullptr, bt, out, b, h, dk, dv, page_size, w, 1, scale,
                    stream);
}

// Resident blocks per SM and dynamic shared memory per block of the K8/K9
// (tiered = 0) or K10 (tiered = 1) kernel at these widths, for the build
// report.
REPRO_EXPORT int flash_mla_occupancy(int rows, int dk, int dv, int is_bf16,
                                     int tiered, int* blocks_per_sm,
                                     int* smem_per_block) {
  if (tiered)
    return is_bf16 ? occupancy<TieredLatentPages<__nv_bfloat16>>(
                         rows, dk, dv, blocks_per_sm, smem_per_block)
                   : occupancy<TieredLatentPages<float>>(
                         rows, dk, dv, blocks_per_sm, smem_per_block);
  return is_bf16 ? occupancy<LatentPages<__nv_bfloat16>>(
                       rows, dk, dv, blocks_per_sm, smem_per_block)
                 : occupancy<LatentPages<float>>(rows, dk, dv, blocks_per_sm,
                                                 smem_per_block);
}
