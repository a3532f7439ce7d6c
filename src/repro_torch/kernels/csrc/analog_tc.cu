// Route "tc" of the analog matmul for Hopper (sm_90a): more than M_DECODE
// rows a request, bf16 x and w, output or no noise, no quant_x / quant_w
// (quant_out is allowed). Plain C entry point for ctypes.
//
// Replaces, for these calls, the Pallas TPU kernel `_kernel` of
// src/repro/kernels/analog_matmul.py (pallas_call at line 208): the f32
// accumulate of bf16 x bf16 products, output noise rs[i] * cs[j] * xi at
// global counters, quant_out.
//
// Bound on the H100: a bf16 x bf16 product on the tensor cores (989
// TFLOP/s) against the operand bytes (3.35 TB/s). At the prefill sites of
// granite-3-8b (256 rows) the bytes bound it (gate/up: 120 MB, 36 us; 27
// GFLOP, 27 us); with more rows the operations do. bf16 x bf16 products are
// exact in f32 and the tensor cores accumulate in f32, so this route differs
// from the simt route and the plain version only in the order of the sums.
// At 256 rows a column tile per 128 columns leaves most of the 132 SMs idle
// at small N (k/v: 16 blocks), so K is split too.
//
// Design:
//   * 128 x 128 output tiles; two consumer warpgroups of 64 rows each run
//     wgmma m64n128k16 (bf16 in, f32 accumulate in registers) with both
//     operands in shared memory; x is K-major, w (K, N) is MN-major (N
//     contiguous), read by wgmma as a transposed B;
//   * one producer warp issues TMA copies of 64-deep x and w tiles (128-byte
//     swizzle) into a 3-stage ring (96 KB, so two blocks share a SM), each
//     stage guarded by a "full" mbarrier (TMA transaction bytes) and an
//     "empty" mbarrier (one arrival per consumer warpgroup); a K tile's stage
//     is released as soon as its products are done (wait_group 0: on the
//     H100 faster than keeping one group in flight, which holds the previous
//     stage until the next tile has arrived), so three loads stay in
//     flight; ragged K, N and row edges are zero-filled by TMA and masked in
//     the epilogue;
//   * K is cut into `splits` (1, 2, 4 or 8; analog_matmul.py tc_plan, from K
//     and the whole weight's N) near-equal runs of whole 64-deep tiles
//     (split_begin), enough for cdiv(N, 128) x splits >= 64 blocks at one
//     row tile: a served prefill's two row tiles then run about a block a
//     SM, which measured fastest. The splits of an output tile are the ranks
//     of one thread-block cluster (grid.z); each stages its f32 partial tile
//     in its (then free) ring. After a cluster barrier, rank q
//     owns 128 / splits rows of the tile: it adds the ranks' partials at
//     those rows through distributed shared memory in rank order 0, 1, ...,
//     splits - 1, adds the noise and requantizes exactly as the simt
//     epilogue does (analog_common.cuh finish_output), 4 columns a thread
//     (the row's seed words and scale read once), and stores whole 16-byte
//     rows; so the draws are spread over the cluster. A second cluster
//     barrier keeps every rank's shared memory alive until its peers have
//     read it. One launch, no workspace;
//   * grid.x runs over row tiles, so the row tiles of one column tile run
//     side by side and share its weights through L2.
// Each output's sum: the wgmma products of each split's K tiles in K order,
// then the splits in rank order. That order depends on (K, N of the whole
// weight) only and each output only on its own row of x: a request's rows
// are the same bits alone or in any batch, a column shard the same bits as
// its slice of the whole call, and every launch the same bits.

#include <cooperative_groups.h>
#include <cuda.h>

#include <utility>

#include "analog_common.cuh"

namespace {

using namespace analog;
namespace cg = cooperative_groups;

// First K tile of split q when `units` tiles are cut into `splits`
// near-equal runs: split q takes [q * units / splits, (q + 1) * units /
// splits). Every split is non-empty when units >= splits. tc_plan and
// split_ranges in analog_matmul.py cut K the same way.
__host__ __device__ __forceinline__ int split_begin(int units, int splits, int q) {
  return (int)(((long long)q * units) / splits);
}

constexpr int T_BM = 128;
constexpr int T_BN = 128;
constexpr int T_BK = 64;  // 128 bytes of bf16: one 128-byte swizzle row
constexpr int T_STAGES = 3;  // 96 KB: two blocks fit a SM, so one's epilogue overlaps the other's loads
constexpr int T_CONSUMERS = 2;                       // warpgroups, 64 rows each
constexpr int T_THREADS = T_CONSUMERS * 128 + 32;    // + one producer warp
constexpr int A_BYTES = T_BM * T_BK * 2;             // 16 KB
constexpr int B_HALF = T_BK * 64 * 2;                // 8 KB: 64 k rows x 64 columns
constexpr int B_BYTES = 2 * B_HALF;                  // 16 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = T_STAGES * STAGE_BYTES;   // 96 KB
constexpr int T_CT = T_BN + 4;                       // row stride of the staged f32 tile
constexpr int BAR_OFFSET = RING_BYTES;               // 2 * T_STAGES mbarriers after the ring
constexpr int T_SMEM = RING_BYTES + 2 * T_STAGES * 8 + 1024;  // + room to align to 1024

static_assert(T_BM * T_CT * 4 <= RING_BYTES, "the f32 tile must fit in the ring");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA copy of a 2-D box at (c0 inner, c1 outer) into this block's
// shared memory at dst; its bytes complete the barrier's transaction.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 f32 a thread) += A (64 x 16, K-major) * B (16 x 128, MN-major)
__device__ __forceinline__ void wgmma_128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// finish_output (analog_common.cuh) of columns c .. c + 3 of flattened row
// r: the same operations on each output, with the row's request, seed words
// and row scale read once
__device__ __forceinline__ float4 finish_quad(const Params& p, int r, int c, float4 y4) {
  float y[4] = {y4.x, y4.y, y4.z, y4.w};
  if (p.noise_kind == NOISE_OUTPUT) {
    const int b = r / p.M;
    const uint32_t li = (uint32_t)(r - b * p.M);
    const uint32_t* s = p.seed + 4 * b;
    const uint32_t k0 = s[0], k1 = s[1], row = s[2] + li, col0 = s[3] + (uint32_t)c;
    const float rs = p.rs[r];
    const float* cs = p.cs + (size_t)b * p.cs_stride + c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xi = repeat_gaussian(k0, k1, row, col0 + (uint32_t)i, p.n_repeats, p.inv_k);
      y[i] = __fadd_rn(y[i], __fmul_rn(__fmul_rn(rs, cs[i]), xi));
    }
  }
  if (p.quant_out) {
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = fake_quant(y[i], p.sc[3], p.sc[4], p.sc[5]);
  }
  return make_float4(y[0], y[1], y[2], y[3]);
}

// grid (row tiles, col tiles, splits), clusters (1, 1, splits); the K run
// of rank q is tiles [split_begin(k_tiles, splits, q), ... (q + 1)).
__global__ void __launch_bounds__(T_THREADS, 2)
    tc_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
              const Params p) {
  extern __shared__ unsigned char tsmem_raw[];
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(tsmem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = ring + BAR_OFFSET;       // T_STAGES barriers
  const uint32_t empty = full + 8 * T_STAGES;    // T_STAGES barriers
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // 0, 1: consumers; 2: the producer warp
  const int rows = p.B * p.M;
  const int row0 = blockIdx.x * T_BM;
  const int col0 = blockIdx.y * T_BN;
  const int k_tiles = (p.K + T_BK - 1) / T_BK;
  const int splits = gridDim.z, q = blockIdx.z;  // the block's rank in its cluster
  const int kt0 = split_begin(k_tiles, splits, q);
  const int n_tiles = split_begin(k_tiles, splits, q + 1) - kt0;

  if (tid == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, T_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  if (wg == T_CONSUMERS) {
    if (tid == T_CONSUMERS * 128) {  // the producer
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % T_STAGES, kt = kt0 + i;
        if (i >= T_STAGES) mbar_wait(empty + 8 * s, ((i / T_STAGES) - 1) & 1);
        const uint32_t a = ring + s * STAGE_BYTES, b = a + A_BYTES;
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load_2d(a, &map_x, full + 8 * s, kt * T_BK, row0);
        tma_load_2d(b, &map_w, full + 8 * s, col0, kt * T_BK);
        tma_load_2d(b + B_HALF, &map_w, full + 8 * s, col0 + 64, kt * T_BK);
      }
    }
  } else {
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % T_STAGES;
      mbar_wait(full + 8 * s, (i / T_STAGES) & 1);
      const uint32_t a = ring + s * STAGE_BYTES + wg * (64 * 128), b = ring + s * STAGE_BYTES + A_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < T_BK / 16; ++ks) {
        // x: K-major, 8-row groups 1024 bytes apart, k16 steps 32 bytes along
        // the swizzled row. w: MN-major, the two 64-column halves 8 KB apart
        // (leading offset), 8-row k groups 1024 bytes apart (stride offset),
        // k16 steps 16 rows of 128 bytes
        wgmma_128(acc, wgmma_desc(a + ks * 32, 16, 1024),
                  wgmma_desc(b + ks * 16 * 128, B_HALF, 1024));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (tid % 128 == 0) mbar_arrive(empty + 8 * s);
    }
  }
  __syncthreads();  // every stage consumed: the ring is free

  // accumulator fragment of m64n128: warp w of the warpgroup holds rows
  // 16w + g and 16w + g + 8 (g = lane / 4); acc[4j + {0, 1}] at columns
  // 8j + 2t + {0, 1} of the first, acc[4j + {2, 3}] of the second (t = lane % 4)
  float* ct = reinterpret_cast<float*>(smem);  // [T_BM][T_CT]
  if (wg < T_CONSUMERS) {
    const int w = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wg * 64 + w * 16 + (lane >> 2) + h * 8;
        const int c = j * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(ct + r * T_CT + c) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }

  // the splits: rank q adds the cluster's partial tiles at its rows in rank
  // order and finishes them, 4 columns (one 16-byte store) a thread
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int own = T_BM / splits;
#pragma unroll 1
  for (int e = tid; e < own * (T_BN / 4); e += T_THREADS) {
    const int rl = q * own + e / (T_BN / 4), cl = (e % (T_BN / 4)) * 4;
    const int r = row0 + rl, c = col0 + cl;
    if (r >= rows || c >= p.N) continue;  // N % 8 == 0: c < N puts all 4 columns in
    float* src = ct + rl * T_CT + cl;
    float4 y = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, 0));
    for (int pr = 1; pr < splits; ++pr) {
      const float4 t = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, pr));
      y = make_float4(__fadd_rn(y.x, t.x), __fadd_rn(y.y, t.y), __fadd_rn(y.z, t.z),
                      __fadd_rn(y.w, t.w));
    }
    *reinterpret_cast<float4*>(p.out + (size_t)r * p.N + c) = finish_quad(p, r, c, y);
  }
  cluster.sync();  // no rank leaves while a peer may still read its tile
}

// Launch `kernel` on grid (gx, gy, splits) with the splits of each (gx, gy)
// as one thread-block cluster (1, 1, splits); one split is a plain launch
// (each block its own cluster of one).
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int threads, int smem,
                           cudaStream_t s, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = grid.z > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// 2-D bf16 map of a row-major (outer, inner) array whose rows are `ld`
// elements apart (ld >= inner: a column shard of a wider array), box
// (box_outer, 64) with the 128-byte swizzle; out-of-bounds elements (past
// `inner` too) read as zero.
bool make_map(CUtensorMap* map, const void* base, int outer, int inner, int ld, int box_outer) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Launch on `stream`; returns the first CUDA error (0 on success). x and w
// bf16, K % 8 == 0, N % 8 == 0, x and w 16-byte aligned, w's rows ldw
// elements apart (ldw % 8 == 0; a column shard's plan comes from the whole
// weight's N). grid_m row tiles and grid_n column tiles of 128 and the
// splits of K (1, 2, 4 or 8) come from tc_plan in analog_matmul.py.
extern "C" int analog_tc_launch(const void* x, const void* w, const float* rs, const float* cs,
                                int cs_stride, const float* wq, const float* sc,
                                const uint32_t* seed, float* out, int B, int M, int K, int N,
                                int ldw, int noise_kind, int quant_out, int n_repeats, float inv_k,
                                int grid_m, int grid_n, int splits, void* stream) {
  const Params p = make_params(x, w, rs, cs, cs_stride, wq, sc, seed, out, B, M, K, N, ldw,
                               noise_kind, 0, 0, quant_out, n_repeats, inv_k);
  if (splits < 1 || splits > 8 || (splits & (splits - 1)) != 0 || (K + T_BK - 1) / T_BK < splits)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, x, B * M, K, K, T_BM) || !make_map(&map_w, w, K, N, ldw, T_BK))
    return (int)cudaErrorInvalidValue;
  static bool ready = false;  // the shared memory limit is raised once a process
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const cudaError_t l = launch_cluster(tc_kernel, dim3(grid_m, grid_n, splits), T_THREADS, T_SMEM,
                                       static_cast<cudaStream_t>(stream), map_x, map_w, p);
  if (l != cudaSuccess) return (int)l;
  return (int)cudaGetLastError();
}
