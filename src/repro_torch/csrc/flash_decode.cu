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
//       function without the copy. K7 has its own kernel, the key split
//       described below; the streamed flag (the reference's legacy
//       baseline, impl='streamed') walks every tile of [0, S) and masks,
//       with output bit-equal to the prefetch walk.
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
// As in the reference, one online-softmax body serves the paged layouts;
// what differs is a key loader (FpPages, TieredPages for K/V pools;
// LatentPages, TieredLatentPages for the one latent pool) and the row
// positions (one position for decode, offset + r / group for a chunk).
//
// Bound on the H100: bytes for K1/K6/K7 (each live key is read once and
// used for 2*G*dh multiply-adds, far below the card's operations-per-byte
// balance); K5 reuses each key for C*G rows, still bytes-bound at the
// serving chunk sizes.
//
// The shared body (K1, K5, K6, K8-K10): one block per (request, KV head)
// and, for K5, per group of at most kChunkRows query rows (grid.y), so
// shared memory stays bounded whatever C is. The block reads its own
// pos, window, offset, hot window and block-table row from device memory
// (this replaces scalar prefetch: no host sync) and loops only over the
// live pages [first, last], so dead keys are never read. One pass covers
// 32 keys, i.e. several pages at the serving page size of 8: K/V rows are
// gathered page by page into shared memory as f32; the query rows, the running max and sum and the unnormalised
// accumulator stay in shared memory for the whole loop. The online softmax
// copies `_softmax_tile`'s guards: alpha = 0 while the running max is
// still -inf, masked keys contribute p = 0, and the output is normalised
// once, acc / max(l, 1e-30), after the last pass. Idle slots (pos 0
// against garbage page 0, always hot) read one page and stay finite.
// Splitting the page axis across blocks (K7's design below), vector loads
// and wgmma for K5's C*G rows are later work.
//
// K7's key split (contig_split_kernel, contig_combine_kernel): one block
// per (request, KV head, key split, group of at most 2 query rows), so a
// batch of 8 x 32 heads gives 768 blocks at S = 160 where one block per
// head gave 256 blocks of 5 serial passes. The wrapper plans the split
// from the shapes only (kernels/flash_decode.py::contig_split_plan):
// absolute tiles of at least 64 keys, whole tiles a split; a split whose
// tiles hold none of the live keys [max(pos - win + 1, 0), min(pos, S -
// 1)] writes m = -inf and exits, and a live split visits only its live
// tiles (every tile when streamed). Inside a split, lpk lanes read one key
// row with 16-byte loads (8 bf16 or 4 f32 a lane) and reduce its dot
// products by shuffles, so no two lanes of a warp read one shared-memory
// bank; each lane group keeps its own online softmax over the keys it
// owns (no block barrier in the key loop), the groups merge by shuffles
// and the warps through shared memory in a fixed order, and the query
// rows of the block share every key row read. The splits' partials (m, l,
// unnormalised acc, in the wrapper's scratch) are merged by the combine
// kernel in split order with `_softmax_tile`'s guards (a split whose m is
// -inf weighs 0) and normalised once. Masked keys are not read and weigh
// exactly 0, and the tiles are absolute, so the streamed walk, which only
// adds masked tiles and splits, gives bit-equal output. The ContigKV
// loader maps (b, kpos, h) to a row; a paged loader on the same kernel is
// the later K1/K6 redesign.
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

// Page loader of the fp pools (K1, K5).
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

// Page loader of the hybrid tier (K6): one tier per page.
template <typename KV>
struct TieredPages {
  static constexpr bool kLatent = false;
  const KV* __restrict__ k;
  const KV* __restrict__ v;
  const int8_t* __restrict__ kq;
  const int8_t* __restrict__ vq;
  const float* __restrict__ ks;
  const float* __restrict__ vs;
  const int* __restrict__ hw;
  int hkv;
  int first_hot;   // blocks >= first_hot are hot

  __device__ __forceinline__ void setup(int pos, int page_size) {
    // hot iff blk > max(pos, 0) / page_size - hw
    first_hot = max(pos, 0) / page_size - hw[0] + 1;
  }
  __device__ __forceinline__ void load(int64_t off, int page, int blk, int h,
                                       float& kk, float& vv) const {
    if (blk >= first_hot) {
      kk = to_f32(k[off]);
      vv = to_f32(v[off]);
    } else {
      const int64_t sc = static_cast<int64_t>(page) * hkv + h;
      kk = round_to_pool<KV>(static_cast<float>(kq[off]) * ks[sc]);
      vv = round_to_pool<KV>(static_cast<float>(vq[off]) * vs[sc]);
    }
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
// per page, the hotness rule and the rounding of TieredPages.
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
TieredPages<KV> tiered_pages(const void* kp, const void* vp, const void* kq,
                             const void* vq, const void* ks, const void* vs,
                             const void* hw, int hkv) {
  return TieredPages<KV>{static_cast<const KV*>(kp),
                         static_cast<const KV*>(vp),
                         static_cast<const int8_t*>(kq),
                         static_cast<const int8_t*>(vq),
                         static_cast<const float*>(ks),
                         static_cast<const float*>(vs),
                         static_cast<const int*>(hw), hkv, 0};
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
// K7: the key axis split over blocks
// ---------------------------------------------------------------------------
// Row loader of the contiguous cache: k/v (B, S, Hkv, dh), the key and
// value rows of (b, kpos, h) at element ((b * S + kpos) * Hkv + h) * dh. A
// paged loader would map kpos through a block table here instead.
template <typename KV>
struct ContigKV {
  const KV* __restrict__ k;
  const KV* __restrict__ v;
  int s, hkv;

  __device__ __forceinline__ int64_t row(int b, int kpos, int h,
                                         int dh) const {
    return ((static_cast<int64_t>(b) * s + kpos) * hkv + h) * dh;
  }
};

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

// The 16-byte pieces at d0 of the key and value rows of keys k0 + u * pass,
// u < kStepKeys; a masked key (outside [lo, hi]) is not read: its p is 0
// and its value row stays 0.
template <typename KV, bool kAligned>
__device__ __forceinline__ void fetch_step(const ContigKV<KV>& kv, int b,
                                           int h, int dh, int d0, int lo,
                                           int hi, int k0, int pass,
                                           uint4 (&kr)[kStepKeys],
                                           uint4 (&vr)[kStepKeys],
                                           bool (&ok)[kStepKeys]) {
#pragma unroll
  for (int u = 0; u < kStepKeys; ++u) {
    const int kpos = k0 + u * pass;
    ok[u] = kpos >= lo && kpos <= hi;
    const int n_el = ok[u] ? dh - d0 : 0;
    const int64_t off = kv.row(b, ok[u] ? kpos : 0, h, dh) + d0;
    kr[u] = load_raw<KV, kAligned>(kv.k + off, n_el);
    vr[u] = load_raw<KV, kAligned>(kv.v + off, n_el);
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
// [lo, hi] = [max(pos - win + 1, 0), min(pos, S - 1)]; unless `streamed`,
// only the tiles holding them are visited, and a split holding none writes
// m = -inf and exits. Lane group `grp` (lpk lanes, 16 bytes of a row
// each) owns key kb + u * (kSplitWarps * 32 / lpk) + warp * (32 / lpk) +
// grp of each step kb and keeps its own online-softmax state over them
// (no block barrier in the key loop); the groups merge by shuffles, then
// the warps through shared memory, in a fixed order. The split's partial
// (m, l, unnormalised acc) goes to part_*.
template <typename KV, int kRows, bool kAligned>
__global__ void __launch_bounds__(kSplitThreads)
contig_split_kernel(ContigKV<KV> kv, const float* __restrict__ q,
                    const int* __restrict__ pos_v,
                    const int* __restrict__ win_v, float* __restrict__ part_m,
                    float* __restrict__ part_l, float* __restrict__ part_acc,
                    int g, int dh, int lpk, int tile, int tiles_per_split,
                    int n_splits, int streamed, float scale) {
  constexpr int V = Vec<KV>::n;
  extern __shared__ float s_red[];   // m, l: kSplitWarps * kRows; acc
  float* s_m = s_red;
  float* s_l = s_m + kSplitWarps * kRows;
  float* s_acc = s_l + kSplitWarps * kRows;   // kSplitWarps * kRows * dh

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
  uint4 kr[kStepKeys], vr[kStepKeys];
  bool ok[kStepKeys];
  // in flight while the query is read; later steps' loads overlap other
  // blocks' work
  fetch_step<KV, kAligned>(kv, b, h, dh, d0, lo, hi, k_first + key0, pass,
                           kr, vr, ok);

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
      fetch_step<KV, kAligned>(kv, b, h, dh, d0, lo, hi, kb + key0, pass, kr,
                               vr, ok);
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
contig_combine_kernel(const float* __restrict__ part_m,
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

template <typename KV, int kRows>
int launch_split(const ContigKV<KV>& kv, bool aligned, const void* q,
                 const void* pos, const void* win, float* pm, float* pl,
                 float* pa, int bhkv, int g, int dh, int lpk, int tile,
                 int tps, int n_splits, int streamed, float scale,
                 cudaStream_t stream) {
  const auto kernel = aligned ? contig_split_kernel<KV, kRows, true>
                              : contig_split_kernel<KV, kRows, false>;
  const dim3 grid(bhkv, n_splits, (g + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * kSplitWarps * kRows * (dh + 2);
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

template <typename KV>
int launch_contig(const void* k, const void* v, const void* q,
                  const void* pos, const void* win, float* pm, float* pl,
                  float* pa, float* out, int b, int s, int hkv, int g, int dh,
                  int rows, int lpk, int tile, int tps, int n_splits,
                  int streamed, float scale, cudaStream_t stream) {
  constexpr int V = Vec<KV>::n;
  const int span = kSplitWarps * (lpk > 0 ? 32 / lpk : 0) * kStepKeys;
  // the plan (kernels/flash_decode.py::contig_split_plan) must cover
  // [0, S) with whole steps, every lane group owning one 16-byte piece
  if ((rows != 1 && rows != 2) || lpk < 1 || lpk > 32 ||
      (lpk & (lpk - 1)) != 0 || lpk * V < dh ||
      tile <= 0 || tile % span != 0 || tps < 1 || n_splits < 1 ||
      static_cast<int64_t>(n_splits) * tps * tile < s)
    return static_cast<int>(cudaErrorInvalidValue);
  const ContigKV<KV> kv{static_cast<const KV*>(k), static_cast<const KV*>(v),
                        s, hkv};
  const bool aligned = (dh * sizeof(KV)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int bhkv = b * hkv;
  const int err =
      rows == 1 ? launch_split<KV, 1>(kv, aligned, q, pos, win, pm, pl, pa,
                                      bhkv, g, dh, lpk, tile, tps, n_splits,
                                      streamed, scale, stream)
                : launch_split<KV, 2>(kv, aligned, q, pos, win, pm, pl, pa,
                                      bhkv, g, dh, lpk, tile, tps, n_splits,
                                      streamed, scale, stream);
  if (err != 0) return err;
  const size_t smem = sizeof(float) * 2 * n_splits * g;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        contig_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(bhkv, (g * dh + kSplitThreads - 1) / kSplitThreads);
  contig_combine_kernel<<<grid, kSplitThreads, smem, stream>>>(
      pm, pl, pa, out, g, dh, n_splits);
  return static_cast<int>(cudaGetLastError());
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

// K1: g query heads per KV head at one position each.
REPRO_EXPORT int flash_decode_paged(const void* q, const void* kp,
                                    const void* vp, const void* pos,
                                    const void* win, const void* bt,
                                    void* out, int b, int hkv, int g, int dh,
                                    int page_size, int w, float scale,
                                    int is_bf16, void* stream) {
  if (b == 0 || hkv == 0 || g == 0) return 0;
  if (is_bf16)
    return launch_gqa(fp_pages<__nv_bfloat16>(kp, vp), q, pos, win, nullptr,
                      bt, out, b, hkv, g, g, dh, page_size, w, 1, scale,
                      stream);
  return launch_gqa(fp_pages<float>(kp, vp), q, pos, win, nullptr, bt, out,
                    b, hkv, g, g, dh, page_size, w, 1, scale, stream);
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

// K6: K1 over the fp/int8 tier pair with (P, Hkv) scales and a (1,) hot
// window in device memory.
REPRO_EXPORT int flash_decode_paged_q8(
    const void* q, const void* kp, const void* vp, const void* kq,
    const void* vq, const void* ks, const void* vs, const void* hw,
    const void* pos, const void* win, const void* bt, void* out, int b,
    int hkv, int g, int dh, int page_size, int w, float scale, int is_bf16,
    void* stream) {
  if (b == 0 || hkv == 0 || g == 0) return 0;
  if (is_bf16)
    return launch_gqa(
        tiered_pages<__nv_bfloat16>(kp, vp, kq, vq, ks, vs, hw, hkv), q, pos,
        win, nullptr, bt, out, b, hkv, g, g, dh, page_size, w, 1, scale,
        stream);
  return launch_gqa(tiered_pages<float>(kp, vp, kq, vq, ks, vs, hw, hkv), q,
                    pos, win, nullptr, bt, out, b, hkv, g, g, dh, page_size,
                    w, 1, scale, stream);
}

// K7: g query heads per KV head at one position each, over a contiguous
// (B, S, Hkv, dh) cache, split over the key axis as planned by the wrapper
// (`rows` query rows a block, lpk lanes a key row, `tile` keys a tile, tps
// tiles a split, n_splits splits); the partials part_m, part_l (B * Hkv, n_splits, g) and part_acc
// (B * Hkv, n_splits, g, dh) are the wrapper's scratch. streamed = 1 walks
// every tile of [0, S).
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
