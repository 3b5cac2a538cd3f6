// K2 and K4: int8 x int8 matrix products over a K-major weight.
//
// Replaces two TPU kernels of src/repro/kernels/yoco_vmm.py:
//   K2 `int8_matmul` (Pallas `_int8_matmul_kernel`): int8 (M, K) x int8
//      (K, N) -> int32 (M, N), no epilogue (prequantized serving: every
//      linear and lm_head of `w8a8 --prequantize`);
//   K4 `yoco_vmm_int8` (Pallas `_yoco_vmm_kernel`): the same product with
//      the fused f32 epilogue acc * sx[m] * sw[n] -> f32 (M, N), multiplied
//      in the reference's order (dynamic `w8a8`: every linear, on the int8
//      codes kernel K3 makes of the activation and of the weight's
//      transpose).
//
// Bound on the H100: at decode (M = slots, a few rows) the product is bound
// by bytes, the K x N int8 weight read over 3.35 TB/s; at prefill (M = the
// prompt length, or 128 rows of lm_head) the operations, 2*M*K*N over the
// 1979 TOP/s int8 tensor rate, come closer, and at M=128 the weight read
// still binds.
//
// Both take their weight K-major: B is the (N, K) row-major int8 tensor
// behind the (K, N) view the wrappers receive (`QuantizedWeight.wq` for K2,
// K3's codes of the K-major float weight's transpose for K4; Hopper's 8-bit
// wgmma reads B only K-major, and a decode GEMV wants each output column's
// K bytes contiguous). The entry points share two kernels and pick one by
// M; K4 is a compile-time variant of each (kScale) whose epilogue scales
// the finished int32 sum, so one K4 call is one launch:
//
//   M >= 64 (prefill): `int8_gemm_wgmma`, a 128 x 128 output tile per block,
//     K stepped 128 bytes at a time. One producer warp issues TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle, zero fill past the M, N and
//     K edges) of the A and B tiles into a ring of 3 stages behind full /
//     empty mbarriers; two consumer warpgroups each run
//     wgmma.mma_async m64n128k32 .s32.s8.s8 with both operands K-major in
//     shared memory and keep the 64 x 128 int32 accumulator in registers,
//     then store it (K4: scaled) straight from registers with the M and N
//     edges masked; in K4 one more warp fetches the tile's 256 scales into
//     shared memory. 99 KB of shared memory a block: two blocks an SM, so
//     one block's epilogue and pipeline fill overlap the other's main loop.
//     Where the output tiles number at most a quarter of the SMs, K is
//     split 4 ways over a thread block cluster and the int32 partial tiles
//     (in the freed stages) are summed through distributed shared memory
//     before the epilogue. TMA needs K % 16 == 0 and 16-byte aligned
//     operands; other shapes take the streaming kernel at any M.
//   M < 64 (decode): `int8_gemv_splitk`, bound by the weight read. Each
//     warp streams 16-byte K-contiguous chunks of 16 output columns
//     (ld.global.nc, no L1 allocation) and multiplies them on the tensor
//     cores with mma.sync m16n8k32 .s32.s8.s8 against activation chunks
//     read through L1 (rows padded to 16 with zeros). The k order inside a
//     16-byte chunk is permuted the same way for A and B, which leaves the
//     sum unchanged. K is split over grid.y so that small N still fills the
//     card (N = 2048 at K = 2048: 32 column tiles x 8 splits); the splits
//     of one column tile form a thread block cluster, and their int32
//     partials are summed through distributed shared memory in split order
//     (one launch, no scratch, no zeroed output, deterministic) before the
//     epilogue.
//
// Both accumulate in int32 and never round mid-reduction (the YOCO
// property), so the sum is exact whichever kernel ran; K4 then rounds
// twice, float(acc) * sx and that * sw (__int2float_rn, __fmul_rn: no
// contraction), as the reference and the plain version do, so its output
// is bit-equal to theirs.
#include <cooperative_groups.h>
#include <cuda.h>
#include <dlfcn.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// The epilogue: K2 stores the int32 sum; K4 (kScale) the f32
// float(acc) * sx[row] * sw[col], in the reference's order, two roundings.
// Where a thread stores from its accumulator registers, K4 reads scales
// fetched while the K loop ran (by a warp of the wgmma kernel's own into
// shared memory, by each GEMV lane into registers before its loop):
// loaded at the end, between stores, their latencies added ~5 us a wave of
// 128 x 128 tiles on the H100. It turns the accumulators into the f32
// results' bits in place and stores them as K2 stores its sums.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float dequant(int acc, float rs, float cs) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs);
}

__device__ __forceinline__ int dequant_bits(int acc, float rs, float cs) {
  return __float_as_int(dequant(acc, rs, cs));
}

// output element idx, of row scale rs and column scale cs[j] (K4 only)
template <bool kScale>
__device__ __forceinline__ void put1(void* c, int64_t idx, int v, float rs,
                                     const float* cs, int j) {
  if constexpr (kScale)
    static_cast<float*>(c)[idx] = dequant(v, rs, cs[j]);
  else
    static_cast<int*>(c)[idx] = v;
}

// elements idx .. idx + 3 (16-byte aligned), column scales cs[j .. j + 3]
template <bool kScale>
__device__ __forceinline__ void put4(void* c, int64_t idx, int4 v, float rs,
                                     const float* cs, int j) {
  if constexpr (kScale)
    *reinterpret_cast<float4*>(static_cast<float*>(c) + idx) = make_float4(
        dequant(v.x, rs, cs[j]), dequant(v.y, rs, cs[j + 1]),
        dequant(v.z, rs, cs[j + 2]), dequant(v.w, rs, cs[j + 3]));
  else
    *reinterpret_cast<int4*>(static_cast<int*>(c) + idx) = v;
}

// ---------------------------------------------------------------------------
// M >= 64: TMA + wgmma
// ---------------------------------------------------------------------------
namespace wg {
constexpr int kBM = 128, kBN = 128, kBK = 128;  // kBK bytes = one swizzle row
constexpr int kStages = 3;
constexpr int kConsumers = 2;                   // warpgroups of 64 rows each
// + one producer warp, and in K4 one warp that fetches the tile's scales
template <bool kScale>
constexpr int kThreadsOf = kConsumers * 128 + (kScale ? 64 : 32);
constexpr int kTileA = kBM * kBK, kTileB = kBN * kBK;
constexpr int kStageBytes = kTileA + kTileB;
// tiles, 1024-byte alignment slack for the swizzle pattern, full and empty
// barriers, K4's scale barrier and the scales of the tile's rows and columns
constexpr size_t kSmem =
    kStages * kStageBytes + 1024 + (2 * kStages + 1) * 8 + (kBM + kBN) * 4;
// a split's int32 partial tile reuses the stages (row stride padded so a
// warp's stores spread over the banks)
constexpr int kPartStride = kBN + 8;
static_assert(kBM * kPartStride * 4 <= kStages * kStageBytes,
              "the partial tile fits in the stages");
constexpr int kSMs = 132;
constexpr int kSplit = 4;                       // K splits of a small grid
}  // namespace wg

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused (1)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (64 x 128 int32, the warpgroup's fragment) += A (64 x 32) . B (32 x 128)
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p;\n}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <bool kScale>
__global__ void __launch_bounds__(wg::kThreadsOf<kScale>, 2)
int8_gemm_wgmma(__grid_constant__ const CUtensorMap map_a,
                __grid_constant__ const CUtensorMap map_b,
                void* __restrict__ c, const float* __restrict__ sx,
                const float* __restrict__ sw, int m, int n, int k,
                int k_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + wg::kStages *
                                                          wg::kStageBytes);
  uint64_t* empty = full + wg::kStages;
  // K4: sx of the tile's rows, then sw of its columns, fetched by the
  // scale warp while the ring fills, behind `scaled`
  uint64_t* scaled = empty + wg::kStages;
  float* s_scale = reinterpret_cast<float*>(scaled + 1);
  const int m0 = blockIdx.y * wg::kBM, n0 = blockIdx.x * wg::kBN;
  // this block's K tiles: split blockIdx.z of gridDim.z (one cluster)
  const int kt0 = blockIdx.z * k_tiles;
  const int n_kt = min((k + wg::kBK - 1) / wg::kBK, kt0 + k_tiles) - kt0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < wg::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], wg::kConsumers * 128);
    }
    mbar_init(scaled, 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int group = tid / 128;

  if (group == wg::kConsumers) {
    // producer warp: one thread keeps the ring full; in K4 the next warp
    // fetches the tile's scales
    const int lane = tid - wg::kConsumers * 128;
    if (lane == 0) {
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % wg::kStages;
        const uint32_t phase = (i / wg::kStages) & 1;
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], wg::kStageBytes);
        uint8_t* tile = smem + s * wg::kStageBytes;
        const int kb = (kt0 + i) * wg::kBK;
        tma_load_2d(tile, &map_a, &full[s], kb, m0);
        tma_load_2d(tile + wg::kTileA, &map_b, &full[s], kb, n0);
      }
    } else if constexpr (kScale) {
      if (lane >= 32) {
        // every load first, then the stores: one load latency, not eight
        constexpr int kPer = (wg::kBM + wg::kBN) / 32;
        float v[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int i = lane - 32 + 32 * u;
          const int row = m0 + i, col = n0 + i - wg::kBM;
          v[u] = i < wg::kBM ? (row < m ? sx[row] : 0.f)
                             : (col < n ? sw[col] : 0.f);
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u) s_scale[lane - 32 + 32 * u] = v[u];
        mbar_arrive(scaled);
      }
    }
  } else {
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % wg::kStages;
      mbar_wait(&full[s], (i / wg::kStages) & 1);
      const uint32_t a_base =
          smem_u32(smem + s * wg::kStageBytes) + group * 64 * wg::kBK;
      const uint32_t b_base = smem_u32(smem + s * wg::kStageBytes +
                                       wg::kTileA);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < wg::kBK / 32; ++kk)
        wgmma_m64n128k32(d, sw128_desc(a_base + kk * 32),
                         sw128_desc(b_base + kk * 32));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      mbar_arrive(&empty[s]);
    }
    // accumulator fragment: warp w of the warpgroup holds rows 16w..16w+15;
    // d[4j + 2h + e] is row g + 8h, column 8j + 2t + e
    const int lane = tid & 31, w = (tid & 127) >> 5;
    const int g = lane >> 2, t = lane & 3;
    if (gridDim.z == 1) {
      if constexpr (kScale) {
        mbar_wait(scaled, 0);
        const float* rsc = s_scale + group * 64 + w * 16 + g;
        const float rs[2] = {rsc[0], rsc[8]};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 cs = *reinterpret_cast<const float2*>(
              s_scale + wg::kBM + 8 * j + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            d[4 * j + 2 * h] = dequant_bits(d[4 * j + 2 * h], rs[h], cs.x);
            d[4 * j + 2 * h + 1] =
                dequant_bits(d[4 * j + 2 * h + 1], rs[h], cs.y);
          }
        }
      }
      // K2's sums, or K4's f32 results as bits
      const bool pair_ok = (n & 1) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + group * 64 + w * 16 + g + 8 * h;
        if (row >= m) continue;
        int* crow = static_cast<int*>(c) + static_cast<int64_t>(row) * n;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = n0 + 8 * j + 2 * t;
          const int v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
          if (pair_ok && col + 1 < n) {
            *reinterpret_cast<int2*>(crow + col) = make_int2(v0, v1);
          } else {
            if (col < n) crow[col] = v0;
            if (col + 1 < n) crow[col + 1] = v1;
          }
        }
      }
    } else {
      // both warpgroups are done reading the stages: the partial tile
      // goes there
      asm volatile("bar.sync 1, %0;" ::"n"(wg::kConsumers * 128) : "memory");
      int* part = reinterpret_cast<int*>(smem);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = group * 64 + w * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<int2*>(part + row * wg::kPartStride + 8 * j +
                                   2 * t) =
              make_int2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      }
    }
  }
  if (gridDim.z > 1) {
    // the K splits of this tile are one cluster: block `rank` sums its
    // share of the tile over every split's partial, in split order
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int splits = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int* part = reinterpret_cast<const int*>(smem);
    const bool quad_ok = (n & 3) == 0;
    constexpr int kThreads = wg::kThreadsOf<kScale>;
    for (int i = rank * kThreads + tid; i < wg::kBM * wg::kBN / 4;
         i += splits * kThreads) {
      const int r = i / (wg::kBN / 4), c4 = (i % (wg::kBN / 4)) * 4;
      const int row = m0 + r, col = n0 + c4;
      if (row >= m || col >= n) continue;
      int4 v = make_int4(0, 0, 0, 0);
      for (int sp = 0; sp < splits; ++sp) {
        const int4 p = *reinterpret_cast<const int4*>(cluster.map_shared_rank(
            part + r * wg::kPartStride + c4, sp));
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      // the epilogue sees the whole sum; the scales were fetched into
      // every block of the cluster before the cluster barrier
      const int64_t idx = static_cast<int64_t>(row) * n + col;
      const float rs = kScale ? s_scale[r] : 0.f;
      const float* cs = s_scale + wg::kBM;
      if (quad_ok && col + 3 < n) {
        put4<kScale>(c, idx, v, rs, cs, c4);
      } else {
        const int vs[4] = {v.x, v.y, v.z, v.w};
        for (int e = 0; e < 4 && col + e < n; ++e)
          put1<kScale>(c, idx + e, vs[e], rs, cs, c4 + e);
      }
    }
    cluster.sync();   // keep this block's partial alive until all have read
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda.so.1 the process has
// loaded (no link-time dependency on libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(
                              dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a (rows, k) row-major int8 operand, loaded as 128 x 128-byte boxes with
// 128-byte swizzle and zero fill outside the tensor
bool k_major_map(CUtensorMap* map, const void* ptr, int rows, int k) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {wg::kBK, wg::kBM};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kScale>
int launch_wgmma(const void* a, const void* b, void* c, const float* sx,
                 const float* sw, int m, int n, int k, cudaStream_t stream) {
  static_assert(wg::kBM == wg::kBN, "one box shape serves A and B");
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_a, map_b;
  if (!k_major_map(&map_a, a, m, k) || !k_major_map(&map_b, b, n, k))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_gemm_wgmma<kScale>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(wg::kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // split K over a cluster of kSplit blocks when the output tiles alone
  // leave most SMs idle (M = 128 through a 2048-wide layer: 16 tiles); on
  // the H100, 8 splits, or splits at 44 tiles, lost more to the partial
  // tiles' reduction than the shorter walk of the TMA ring gained
  const int n_tiles = (n + wg::kBN - 1) / wg::kBN;
  const int m_tiles = (m + wg::kBM - 1) / wg::kBM;
  const int n_k = (k + wg::kBK - 1) / wg::kBK;
  int splits = n_tiles * m_tiles <= wg::kSMs / 4 ? min(wg::kSplit, n_k) : 1;
  const int k_tiles = (n_k + splits - 1) / splits;
  splits = (n_k + k_tiles - 1) / k_tiles;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles, m_tiles, splits);
  cfg.blockDim = dim3(wg::kThreadsOf<kScale>);
  cfg.dynamicSmemBytes = wg::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 1;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = splits;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, int8_gemm_wgmma<kScale>,
                                           map_a, map_b, c, sx, sw, m, n, k,
                                           k_tiles);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// M < 64: split-K streaming GEMV on mma.sync
// ---------------------------------------------------------------------------
namespace sk {
constexpr int kWarps = 4, kThreads = kWarps * 32;
constexpr int kGroups = 2;                      // 8-column groups a warp
constexpr int kCols = kWarps * kGroups * 8;     // 64 columns a block
constexpr int kStep = 64;                       // K bytes a step: 4 lanes x 16
constexpr int kSliceUnit = 4 * kStep;           // a split's K bytes: its multiple
constexpr int kMaxSplit = 8;                    // portable cluster size
constexpr int kTargetBlocks = 4 * 132;          // a few blocks an SM
}  // namespace sk

// 16 bytes at p, of which `valid` (<= 0: none) lie inside the row; the
// aligned form needs a 16-byte aligned p and valid either <= 0 or >= 16
template <bool kAligned, bool kStream>
__device__ __forceinline__ uint4 load16(const int8_t* p, int valid) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (valid <= 0) return v;
  if (kAligned) {
    if (kStream)
      asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "l"(p));
    else
      v = __ldg(reinterpret_cast<const uint4*>(p));
    return v;
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < valid)
      w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i]))
                  << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid (column tiles of 64, K splits, row groups of 16 * kMT); the K splits
// of a column tile are one cluster. Lane (g, t) owns output column g of each of
// its warp's 8-column groups and reads bytes [16t, 16t + 16) of every
// 64-byte K step of that column and of rows g and g + 8 of each 16-row
// tile. mma.sync pairs A's and B's k by the owning lane's t, so feeding
// both the same 16 bytes in the order (x, y) then (z, w) keeps the dot
// product exact.
template <bool kAligned, int kMT, bool kScale>
__global__ void __launch_bounds__(sk::kThreads)
int8_gemv_splitk(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 void* __restrict__ c, const float* __restrict__ sx,
                 const float* __restrict__ sw, int m, int n, int k,
                 int k_slice) {
  constexpr int kRows = kMT * 16;
  // steps whose weight loads fly at once: more where fewer rows leave the
  // registers free
  constexpr int kUnroll = kMT == 1 ? 8 : 4;
  extern __shared__ int s_part[];   // (kRows, kCols) when split
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * sk::kCols;
  const int m_base = blockIdx.z * kRows;
  const int k_begin = blockIdx.y * k_slice;
  const int k_end = min(k, k_begin + k_slice);
  const int n_mt = min(kMT, (m - m_base + 15) / 16);
  int acc[kMT][sk::kGroups][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < sk::kGroups; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int8_t* bcol[sk::kGroups];
  bool col_ok[sk::kGroups];
#pragma unroll
  for (int j = 0; j < sk::kGroups; ++j) {
    const int col = col0 + (warp * sk::kGroups + j) * 8 + g;
    col_ok[j] = col < n;
    bcol[j] = b + static_cast<int64_t>(col_ok[j] ? col : 0) * k;
  }

  // K4 without a split: the scales of this lane's outputs, fetched before
  // the K loop
  float cs[sk::kGroups][2], rs[kMT][2];
  if constexpr (kScale) {
    if (gridDim.y == 1) {
#pragma unroll
      for (int j = 0; j < sk::kGroups; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + (warp * sk::kGroups + j) * 8 + 2 * t + e;
          cs[j][e] = col < n ? sw[col] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m_base + i * 16 + g + 8 * h;
          rs[i][h] = row < m ? sx[row] : 0.f;
        }
    }
  }

  for (int kb = k_begin; kb < k_end; kb += kUnroll * sk::kStep) {
    // every weight load of kUnroll steps first, then their products
    uint4 bv[kUnroll][sk::kGroups];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kc = kb + u * sk::kStep + 16 * t;
#pragma unroll
      for (int j = 0; j < sk::kGroups; ++j)
        bv[u][j] = load16<kAligned, true>(bcol[j] + kc,
                                          col_ok[j] ? k_end - kc : 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kc = kb + u * sk::kStep + 16 * t;
      const int valid = k_end - kc;
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        if (i >= n_mt) break;
        const int r0 = m_base + i * 16 + g, r1 = r0 + 8;
        const uint4 a0 = load16<kAligned, false>(
            a + static_cast<int64_t>(r0 < m ? r0 : 0) * k + kc,
            r0 < m ? valid : 0);
        const uint4 a1 = load16<kAligned, false>(
            a + static_cast<int64_t>(r1 < m ? r1 : 0) * k + kc,
            r1 < m ? valid : 0);
#pragma unroll
        for (int j = 0; j < sk::kGroups; ++j) {
          mma_s8(acc[i][j], a0.x, a1.x, a0.y, a1.y, bv[u][j].x, bv[u][j].y);
          mma_s8(acc[i][j], a0.z, a1.z, a0.w, a1.w, bv[u][j].z, bv[u][j].w);
        }
      }
    }
  }

  // accumulator fragment: acc[i][j][2h + e] is row 16i + g + 8h, column
  // 8 * (warp * kGroups + j) + 2t + e of the block's tile
  if (gridDim.y == 1) {
    if constexpr (kScale) {
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < sk::kGroups; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              int& v = acc[i][j][2 * h + e];
              v = dequant_bits(v, rs[i][h], cs[j][e]);
            }
    }
    // K2's sums, or K4's f32 results as bits
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      if (i >= n_mt) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m_base + i * 16 + g + 8 * h;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < sk::kGroups; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + (warp * sk::kGroups + j) * 8 + 2 * t + e;
            if (col < n)
              static_cast<int*>(c)[static_cast<int64_t>(row) * n + col] =
                  acc[i][j][2 * h + e];
          }
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    if (i >= n_mt) break;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < sk::kGroups; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s_part[(i * 16 + g + 8 * h) * sk::kCols +
                 (warp * sk::kGroups + j) * 8 + 2 * t + e] =
              acc[i][j][2 * h + e];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // block `rank` sums its share of the tile over every split, in split order
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int total = min(kRows, m - m_base) * sk::kCols;
  for (int i = rank * sk::kThreads + tid; i < total;
       i += splits * sk::kThreads) {
    int v = 0;
    for (int s = 0; s < splits; ++s) v += *cluster.map_shared_rank(s_part + i, s);
    const int row = m_base + i / sk::kCols, col = col0 + i % sk::kCols;
    // the epilogue sees the whole sum
    if (col < n)
      put1<kScale>(c, static_cast<int64_t>(row) * n + col, v,
                   kScale ? sx[row] : 0.f, sw, col);
  }
  cluster.sync();   // keep this block's partials alive until all have read
}

template <bool kScale>
int launch_splitk(const void* a, const void* b, void* c, const float* sx,
                  const float* sw, int m, int n, int k, bool aligned,
                  cudaStream_t stream) {
  // one 16-row tile a block at decode's few rows, four above
  const int mt = m <= 16 ? 1 : 4;
  const int rows = 16 * mt;
  const int col_tiles = (n + sk::kCols - 1) / sk::kCols;
  const int row_groups = (m + rows - 1) / rows;
  int splits = (sk::kTargetBlocks + col_tiles * row_groups - 1) /
               (col_tiles * row_groups);
  splits = min(splits, sk::kMaxSplit);
  splits = min(splits, (k + sk::kSliceUnit - 1) / sk::kSliceUnit);
  splits = max(splits, 1);
  const int per = (k + splits - 1) / splits;
  const int k_slice =
      (per + sk::kSliceUnit - 1) / sk::kSliceUnit * sk::kSliceUnit;
  splits = (k + k_slice - 1) / k_slice;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(col_tiles, splits, row_groups);
  cfg.blockDim = dim3(sk::kThreads);
  cfg.dynamicSmemBytes = splits > 1 ? rows * sk::kCols * sizeof(int) : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const auto kernel =
      mt == 1 ? (aligned ? int8_gemv_splitk<true, 1, kScale>
                         : int8_gemv_splitk<false, 1, kScale>)
              : (aligned ? int8_gemv_splitk<true, 4, kScale>
                         : int8_gemv_splitk<false, 4, kScale>);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int8_t*>(a),
      static_cast<const int8_t*>(b), c, sx, sw, m, n, k, k_slice);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the product over a K-major weight b_nk, K2's (kScale false) or K4's
template <bool kScale>
int product(const void* a, const void* b_nk, void* c, const float* sx,
            const float* sw, int m, int n, int k, cudaStream_t s) {
  if (m == 0 || n == 0) return 0;
  // an empty sum: int32 0, or K4's 0 * sx * sw (+0.0f, all bits 0)
  if (k == 0) return static_cast<int>(cudaMemsetAsync(
      c, 0, 4 * static_cast<size_t>(m) * n, s));
  const bool aligned = k % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b_nk) % 16 == 0;
  if (m >= 64 && aligned)
    return launch_wgmma<kScale>(a, b_nk, c, sx, sw, m, n, k, s);
  return launch_splitk<kScale>(a, b_nk, c, sx, sw, m, n, k, aligned, s);
}

}  // namespace

// K2: a (M, K) int8 row-major, b_nk (N, K) int8 row-major (the K-major
// weight), c (M, N) int32.
REPRO_EXPORT int int8_matmul(const void* a, const void* b_nk, void* c, int m,
                             int n, int k, void* stream) {
  return product<false>(a, b_nk, c, nullptr, nullptr, m, n, k,
                        static_cast<cudaStream_t>(stream));
}

// K4: a (M, K) int8 row-major, b_nk (N, K) int8 row-major (the K-major
// weight), sx (M, 1) and sw (1, N) f32, c (M, N) f32.
REPRO_EXPORT int yoco_vmm_int8(const void* a, const void* b_nk, const void* sx,
                               const void* sw, void* c, int m, int n, int k,
                               void* stream) {
  return product<true>(a, b_nk, c, static_cast<const float*>(sx),
                       static_cast<const float*>(sw), m, n, k,
                       static_cast<cudaStream_t>(stream));
}
