// Paged flash attention over a GQA KV pool: kernels K1, K5 and K6.
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
// All three return f32 (B, Hkv, rows, dh).
//
// As in the reference, one online-softmax body serves every layout; what
// differs is a page loader (FpPages, TieredPages) and the row positions
// (one position for decode, offset + r / G for a chunk).
//
// Bound on the H100: bytes for K1/K6 (each live key is read once and used
// for 2*G*dh multiply-adds, far below the card's operations-per-byte
// balance); K5 reuses each key for C*G rows, still bytes-bound at the
// serving chunk sizes. Design: one block per (request, KV head) and, for
// K5, per group of at most kChunkRows query rows (grid.y), so shared
// memory stays bounded whatever C is. The block reads its own pos, window,
// offset, hot window and block-table row from device memory (this
// replaces scalar prefetch: no host sync) and loops only over the live
// pages [first, last], so dead pages are never read. One pass covers 32
// keys, i.e. several pages at the serving page size of 8: K/V rows are
// gathered page by page into shared memory as f32; the query rows, the
// running max and sum and the unnormalised accumulator stay in shared
// memory for the whole loop. The online softmax copies `_softmax_tile`'s
// guards: alpha = 0 while the running max is still -inf, masked keys
// contribute p = 0, and the output is normalised once,
// acc / max(l, 1e-30), after the last pass. Idle slots (pos 0 against
// garbage page 0, always hot) read one page and stay finite. Splitting the
// page axis across blocks, cp.async/TMA staging, vector loads and wgmma
// for K5's C*G rows are later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kKeys = 32;       // keys per pass: one per lane in the softmax
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = 32;  // K5 query rows per block

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
                    int dh, int page_size, int w, int chunk, int group,
                    float scale) {
  extern __shared__ float smem[];
  float* s_q = smem;                   // rpb * dh
  float* s_acc = s_q + rpb * dh;       // rpb * dh
  float* s_k = s_acc + rpb * dh;       // kKeys * dh
  float* s_v = s_k + kKeys * dh;       // kKeys * dh
  float* s_p = s_v + kKeys * dh;       // rpb * kKeys
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
  const int64_t qo = (static_cast<int64_t>(blockIdx.x) * rows + r0) * dh;
  Pages pg = pages;
  pg.setup(pos, page_size);

  for (int i = tid; i < nr * dh; i += kThreads) {
    s_q[i] = q[qo + i];
    s_acc[i] = 0.f;
  }
  for (int i = tid; i < nr; i += kThreads) {
    s_m[i] = -INFINITY;
    s_l[i] = 0.f;
  }
  __syncthreads();

  // _live_block_range of the (fetch-union) scalars: [first, last] blocks
  // holding any valid key
  const int first = max(pos - win + 1, 0) / page_size;
  const int last = min(max(pos, 0) / page_size, w - 1);
  const int k_begin = first * page_size, k_end = (last + 1) * page_size;

  for (int t0 = k_begin; t0 < k_end; t0 += kKeys) {
    for (int i = tid; i < kKeys * dh; i += kThreads) {
      const int j = i / dh, d = i - j * dh;
      const int kpos = t0 + j;
      float kk = 0.f, vv = 0.f;
      if (kpos < k_end) {
        const int blk = kpos / page_size;
        const int page = bt[blk];
        const int64_t off =
            ((static_cast<int64_t>(page) * page_size + kpos % page_size) * hkv +
             h) * dh + d;
        pg.load(off, page, blk, h, kk, vv);
      }
      s_k[i] = kk;
      s_v[i] = vv;
    }
    __syncthreads();
    for (int i = tid; i < nr * kKeys; i += kThreads) {
      const int gi = i / kKeys, j = i - gi * kKeys;
      const int kpos = t0 + j;
      const int qp = base + (r0 + gi) / group;
      const bool valid = kpos < k_end && kpos <= qp && kpos > qp - row_win;
      float dot = 0.f;
      if (valid)
        for (int d = 0; d < dh; ++d) dot += s_q[gi * dh + d] * s_k[j * dh + d];
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
    for (int i = tid; i < nr * dh; i += kThreads) {
      const int gi = i / dh, d = i - gi * dh;
      float pv = 0.f;
      for (int j = 0; j < kKeys; ++j) pv += s_p[gi * kKeys + j] * s_v[j * dh + d];
      s_acc[i] = s_acc[i] * s_alpha[gi] + pv;
    }
    __syncthreads();
  }

  // the one output conversion: normalise once, after the full reduction
  for (int i = tid; i < nr * dh; i += kThreads)
    out[qo + i] = s_acc[i] / fmaxf(s_l[i / dh], 1e-30f);
}

template <typename Pages>
int launch(const Pages& pages, const void* q, const void* pos,
           const void* win, const void* off, const void* bt, void* out,
           int b, int hkv, int rows, int rpb, int dh, int page_size, int w,
           int chunk, float scale, void* stream) {
  const size_t smem =
      sizeof(float) * (2 * rpb * dh + 2 * kKeys * dh + rpb * kKeys + 3 * rpb);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attend_kernel<Pages>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(b * hkv, (rows + rpb - 1) / rpb);
  paged_attend_kernel<Pages><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      pages, static_cast<const float*>(q), static_cast<const int*>(pos),
      static_cast<const int*>(win), static_cast<const int*>(off),
      static_cast<const int*>(bt), static_cast<float*>(out), hkv, rows, rpb,
      dh, page_size, w, chunk, rows / chunk, scale);
  return static_cast<int>(cudaGetLastError());
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
    return launch(fp_pages<__nv_bfloat16>(kp, vp), q, pos, win, nullptr, bt,
                  out, b, hkv, g, g, dh, page_size, w, 1, scale, stream);
  return launch(fp_pages<float>(kp, vp), q, pos, win, nullptr, bt, out, b,
                hkv, g, g, dh, page_size, w, 1, scale, stream);
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
    return launch(fp_pages<__nv_bfloat16>(kp, vp), q, pos, win, off, bt, out,
                  b, hkv, rows, rpb, dh, page_size, w, chunk, scale, stream);
  return launch(fp_pages<float>(kp, vp), q, pos, win, off, bt, out, b, hkv,
                rows, rpb, dh, page_size, w, chunk, scale, stream);
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
    return launch(
        tiered_pages<__nv_bfloat16>(kp, vp, kq, vq, ks, vs, hw, hkv), q, pos,
        win, nullptr, bt, out, b, hkv, g, g, dh, page_size, w, 1, scale,
        stream);
  return launch(tiered_pages<float>(kp, vp, kq, vq, ks, vs, hw, hkv), q, pos,
                win, nullptr, bt, out, b, hkv, g, g, dh, page_size, w, 1,
                scale, stream);
}
