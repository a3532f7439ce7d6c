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
//
// Design:
//   * 128 x 128 output tiles; two consumer warpgroups of 64 rows each run
//     wgmma m64n128k16 (bf16 in, f32 accumulate in registers) with both
//     operands in shared memory; x is K-major, w (K, N) is MN-major (N
//     contiguous), read by wgmma as a transposed B;
//   * one producer warp issues TMA copies of 64-deep x and w tiles (128-byte
//     swizzle) into a 3-stage ring (96 KB, so two blocks share a SM and one
//     block's epilogue overlaps the other's loads and products), each
//     stage guarded by a "full" mbarrier
//     (TMA transaction bytes) and an "empty" mbarrier (one arrival per
//     consumer warpgroup); ragged K, N and row edges are zero-filled by TMA
//     and masked in the epilogue;
//   * grid.x runs over row tiles, so the row tiles of one column tile run
//     side by side and share its weights through L2;
//   * the epilogue maps each accumulator fragment element to its (row, col)
//     and stages the f32 tile in the (then free) ring; one loop then adds
//     the noise and requantizes exactly as the simt epilogue does
//     (analog_common.cuh finish_output) and stores whole rows. Unrolled over
//     the 64 fragment elements of a thread, the noise code (Threefry, logf,
//     cosf) would be inlined 64 times and overflow the instruction cache.
// A K tile's products enter every output's sum in K order and each output
// depends only on its own row of x: a request's rows are the same bits alone
// or in any batch, and from launch to launch.

#include <cuda.h>

#include "analog_common.cuh"

namespace {

using namespace analog;

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
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % T_STAGES;
        if (kt >= T_STAGES) mbar_wait(empty + 8 * s, ((kt / T_STAGES) - 1) & 1);
        const uint32_t a = ring + s * STAGE_BYTES, b = a + A_BYTES;
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load_2d(a, &map_x, full + 8 * s, kt * T_BK, row0);
        tma_load_2d(b, &map_w, full + 8 * s, col0, kt * T_BK);
        tma_load_2d(b + B_HALF, &map_w, full + 8 * s, col0 + 64, kt * T_BK);
      }
    }
  } else {
    for (int kt = 0; kt < k_tiles; ++kt) {
      const int s = kt % T_STAGES;
      mbar_wait(full + 8 * s, (kt / T_STAGES) & 1);
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
  __syncthreads();
#pragma unroll 1
  for (int e = tid; e < T_BM * T_BN; e += T_THREADS) {
    const int rl = e / T_BN, cl = e % T_BN;
    const int r = row0 + rl, c = col0 + cl;
    if (r < rows && c < p.N) p.out[(size_t)r * p.N + c] = finish_output(p, r, c, ct[rl * T_CT + cl]);
  }
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
// elements apart (ldw % 8 == 0; a column shard's K order is the whole
// weight's: every 64-deep K tile in order). grid_m row tiles
// and grid_n column tiles of 128 come from tc_plan in analog_matmul.py.
extern "C" int analog_tc_launch(const void* x, const void* w, const float* rs, const float* cs,
                                int cs_stride, const float* wq, const float* sc,
                                const uint32_t* seed, float* out, int B, int M, int K, int N,
                                int ldw, int noise_kind, int quant_out, int n_repeats, float inv_k,
                                int grid_m, int grid_n, void* stream) {
  const Params p = make_params(x, w, rs, cs, cs_stride, wq, sc, seed, out, B, M, K, N, ldw,
                               noise_kind, 0, 0, quant_out, n_repeats, inv_k);
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, x, B * M, K, K, T_BM) || !make_map(&map_w, w, K, N, ldw, T_BK))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
  if (e != cudaSuccess) return (int)e;
  tc_kernel<<<dim3(grid_m, grid_n), T_THREADS, T_SMEM, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, p);
  return (int)cudaGetLastError();
}
