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
//       cache a step); here the key loop is bounded by S and keys at or
//       past S are masked, the same function without the copy. The live
//       range is cut at 32-key granularity (the prefetch path): only the
//       tiles holding [max(pos - win + 1, 0), min(pos, S - 1)] are read.
//       The streamed flag (the reference's legacy baseline,
//       impl='streamed') loops over every tile of [0, S) and masks; a
//       fully masked tile leaves the running max, sum and accumulator
//       bit-unchanged, so both paths give bit-equal outputs.
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
// As in the reference, one online-softmax body serves every layout; what
// differs is a key loader (FpPages, TieredPages for K/V pools; ContigKV for
// the contiguous cache; LatentPages, TieredLatentPages for the one latent
// pool) and the row positions (one position for decode, offset + r / group
// for a chunk).
//
// Bound on the H100: bytes for K1/K6/K7 (each live key is read once and
// used for 2*G*dh multiply-adds, far below the card's operations-per-byte
// balance); K5 reuses each key for C*G rows, still bytes-bound at the
// serving chunk sizes. Design: one block per (request, KV head) and, for
// K5 and K7, per group of at most kChunkRows query rows (grid.y), so
// shared memory stays bounded whatever C or G is. The block reads its own
// pos, window, offset, hot window and block-table row from device memory
// (this replaces scalar prefetch: no host sync) and loops only over the
// live pages [first, last] (K7: the live 32-key tiles), so dead keys are
// never read. One pass covers 32 keys, i.e. several pages at the serving
// page size of 8: K/V rows are gathered page by page into shared memory
// as f32; the query rows, the running max and sum and the unnormalised
// accumulator stay in shared memory for the whole loop. The online softmax
// copies `_softmax_tile`'s guards: alpha = 0 while the running max is
// still -inf, masked keys contribute p = 0, and the output is normalised
// once, acc / max(l, 1e-30), after the last pass. Idle slots (pos 0
// against garbage page 0, always hot) read one page and stay finite.
// Splitting the page axis across blocks, cp.async/TMA staging, vector
// loads and wgmma for K5's C*G rows are later work.
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
  static constexpr bool kContig = false;
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
  static constexpr bool kContig = false;
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

// Key loader of the contiguous cache (K7): k/v (B, S, Hkv, dh), no block
// table; FpPages' reads at the offset of (b, kpos, head, d). The kernel
// takes S in its page_size argument (w = 1) and cuts the live range at key
// granularity; kStreamed walks every tile of [0, S).
template <typename KV, bool kStreamedT>
struct ContigKV : FpPages<KV> {
  static constexpr bool kContig = true;
  static constexpr bool kStreamed = kStreamedT;
};

// Page loader of the fp latent pool (K8, K9): one value per (page, row,
// column), used as a key and, in its first DV columns, as a value.
template <typename KV>
struct LatentPages {
  static constexpr bool kLatent = true;
  static constexpr bool kContig = false;
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
  static constexpr bool kContig = false;
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
// rows), and attends kpos in (qp - (win - (chunk - 1)), qp]. For the
// contiguous loader page_size is the cache length S, w is 1 and
// block_tables is null.
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
  const int* bt =
      Pages::kContig ? nullptr : block_tables + static_cast<int64_t>(b) * w;
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
  // holding any valid key. Contiguous: the 32-key tiles holding
  // [max(pos - win + 1, 0), min(pos, S - 1)] (every tile when streamed),
  // tile-aligned so both paths reduce over the same tiles.
  int k_begin, k_end;
  if constexpr (Pages::kContig) {
    k_begin = Pages::kStreamed ? 0 : max(pos - win + 1, 0) / kKeys * kKeys;
    k_end = Pages::kStreamed ? page_size : min(pos, page_size - 1) + 1;
  } else {
    const int first = max(pos - win + 1, 0) / page_size;
    const int last = min(max(pos, 0) / page_size, w - 1);
    k_begin = first * page_size;
    k_end = (last + 1) * page_size;
  }

  for (int t0 = k_begin; t0 < k_end; t0 += kKeys) {
    for (int i = tid; i < kKeys * dk; i += kThreads) {
      const int j = i / dk, d = i - j * dk;
      const int kpos = t0 + j;
      float kk = 0.f, vv = 0.f;
      if (kpos < k_end) {
        int blk = 0, page = 0;
        int64_t off;
        if constexpr (Pages::kContig) {
          off = ((static_cast<int64_t>(b) * page_size + kpos) * hkv + h) * dk +
                d;
        } else {
          blk = kpos / page_size;
          page = bt[blk];
          off = ((static_cast<int64_t>(page) * page_size + kpos % page_size) *
                     hkv + h) * dk + d;
        }
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

template <typename KV, bool kStreamed>
int launch_contig(const void* k, const void* v, const void* q,
                  const void* pos, const void* win, void* out, int b, int s,
                  int hkv, int g, int dh, float scale, void* stream) {
  const int rpb = g < kChunkRows ? g : kChunkRows;
  return launch_gqa(ContigKV<KV, kStreamed>{fp_pages<KV>(k, v)}, q, pos, win,
                    nullptr, nullptr, out, b, hkv, g, rpb, dh, s, 1, 1, scale,
                    stream);
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
// (B, S, Hkv, dh) cache; streamed = 1 walks every key tile of [0, S).
REPRO_EXPORT int flash_decode_contig(const void* q, const void* k,
                                     const void* v, const void* pos,
                                     const void* win, void* out, int b,
                                     int s, int hkv, int g, int dh,
                                     float scale, int is_bf16, int streamed,
                                     void* stream) {
  if (b == 0 || hkv == 0 || g == 0 || s == 0) return 0;
  if (is_bf16)
    return streamed ? launch_contig<__nv_bfloat16, true>(
                          k, v, q, pos, win, out, b, s, hkv, g, dh, scale,
                          stream)
                    : launch_contig<__nv_bfloat16, false>(
                          k, v, q, pos, win, out, b, s, hkv, g, dh, scale,
                          stream);
  return streamed ? launch_contig<float, true>(k, v, q, pos, win, out, b, s,
                                               hkv, g, dh, scale, stream)
                  : launch_contig<float, false>(k, v, q, pos, win, out, b, s,
                                                hkv, g, dh, scale, stream);
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
