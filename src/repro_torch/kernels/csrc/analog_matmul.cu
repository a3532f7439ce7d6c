// Route "simt" of the analog matmul for Hopper (sm_90a): tensor-core
// products of split bf16 parts. Plain C entry points for ctypes.
//
// Replaces the Pallas TPU kernel `_kernel` / `analog_matmul_raw` of
// src/repro/kernels/analog_matmul.py (pallas_call at line 208) and the
// in-register noise of src/repro/kernels/prng.py, for what the other routes
// do not take (src/repro_torch/kernels/analog_matmul.py select_route): f32
// operands (every convolution), rows not a multiple of 16 bytes, quant_x /
// quant_w above M_DECODE rows, weight noise with input quantizers there.
// Per output element it computes, in this order:
//   1. optional per-tensor fake-quant of x            (scalars[0:3])
//   2. optional per-channel fake-quant of w           (wq rows: delta, zp, bins)
//   3. noise_kind == weight: w += cs[j] * xi(k, col0 + j), key k0 ^ SALT
//   4. the f32 accumulate over K, ragged K/M/N edges zero
//   5. noise_kind == output: y += rs[i] * cs[j] * xi(row0 + i, col0 + j)
//   6. optional output fake-quant                     (scalars[3:6])
// xi is the mean of n_repeats Threefry-2x32-20 / Box-Muller streams whose k1
// is xor-ed with r * 0x85EBCA6B (analog_common.cuh). The noise tensor never
// exists in memory.
//
// Bound on the H100: at ResNet-50's conv1 (200,704 x 147 @ 147 x 64) the f32
// patches and the f32 output (169 MB, 0.05 ms at 3.35 TB/s); at the 3x3
// sites the products; under output noise at the 1x1 sites the draws. An
// f32 product on the SIMT lanes runs at 67 TFLOP/s; on the tensor cores as
// three bf16 products at 989 TFLOP/s, which is how this kernel multiplies:
//   * every operand value v (f32, or f32 after fake-quant or weight noise)
//     is split into hi = bf16(v) and lo = bf16(v - hi); a product is
//     hi*hi + hi*lo + lo*hi, accumulated in f32 by wgmma m64n64k16. The
//     dropped lo*lo and the residual v - hi - lo leave about 3 * 2^-18 of
//     |x*w| a product, inside the reference's rule (3e-5 * max|y| +
//     1e-4 * |y|; tests/test_torch_routes.py holds the arithmetic on the
//     CPU). An operand that is bf16 and unchanged (no quantizer, no weight
//     noise) has lo = 0: its lo products are not issued. bf16 rather than
//     3 x TF32: wgmma reads a bf16 B MN-major, so the row-major (K, N)
//     weight needs no transpose, at twice TF32's rate;
//   * output tiles of 128 rows and 64 columns; two warpgroups a block, each
//     multiplying its 64 rows; two blocks a SM; K in 32-deep steps;
//   * f32 (or bf16) steps of x and w stream into a ring of two stages in
//     shared memory: by TMA (one thread, an mbarrier a stage) where an
//     operand's rows are 16-byte multiples and its base 16-byte aligned; by
//     4-byte cp.async where f32 rows are not (conv1's K = 147: 588-byte
//     rows); by plain loads for bf16 rows of odd length. Ragged rows, K and
//     columns read as zero;
//   * a converting stage (both warpgroups) reads a step from the ring,
//     applies quant_x, quant_w and the weight noise (drawn at the counters
//     (k, col0 + j), key k0 ^ WEIGHT_STREAM_SALT, as the route always drew
//     it, four draws side by side), splits each value and writes the hi and
//     lo bf16 parts in wgmma's 128-byte-swizzled layout (x K-major, w
//     MN-major) into one half of two-step-deep part tiles; a step's
//     products run on while the next step is copied and converted into the
//     other half;
//   * the tiles (request under weight noise, row tile, column tile) are
//     enumerated on grid.x by a persistent grid of as many clusters as the
//     card holds, each walking tiles i, i + clusters, ...: no limit of
//     65,535 row tiles; addresses are 64-bit; the ring runs on across
//     tiles, so a tile's epilogue overlaps the next one's copies. Under
//     weight noise a tile never mixes requests (the noisy weight differs
//     per request);
//   * K's steps are cut into `splits` (1, 2, 4 or 8; analog_matmul.py
//     simt_plan, from K and the whole weight's N) runs (split_begin),
//     enough for small-row calls (the 7x7 stage: 784 rows; the fc: 16) to
//     fill the card. The splits of a tile are the ranks of one thread-block
//     cluster; each stages its f32 partial tile over its (then free)
//     parts; rank q adds the partials of its 128 / splits rows through
//     distributed shared memory in rank order and finishes them
//     (finish_output's operations, analog_common.cuh: output noise,
//     requant), four columns a thread with four draws side by side.
// Measured choices (H100 80GB HBM3, 700 W; chip_smoke.py conv, PERF.md):
// 128 x 64 tiles with both warpgroups multiplying beat 64 x 64 and 64 x 128
// tiles with one (a ResNet-50 forward's simt kernels 4.33 against 5.24 ms);
// more stages at one block a SM and an mbarrier pipeline in place of the
// block barriers were slower.
// Each output's sum: the three products of each 16-deep step, the steps of
// each split in K order, then the splits in rank order. That order depends
// on (K, N of the whole weight) only and each output
// only on its own row of x and column of w: a request's rows are the same
// bits alone or in any batch, a column shard the same bits as its slice of
// the whole call, and every launch the same bits.

#include <cooperative_groups.h>
#include <cuda.h>

#include "analog_common.cuh"

namespace {

using namespace analog;
namespace cg = cooperative_groups;

constexpr int S_BM = 128;       // rows of an output tile: 64 a warpgroup (wgmma m64)
constexpr int S_BN = 64;        // columns of an output tile (wgmma n64)
constexpr int S_BK = 32;        // K depth of a step: two wgmma k16
constexpr int S_THREADS = 256;  // two warpgroups: each copies, converts and multiplies
constexpr int STAGES = 2;       // the ring of f32 (or bf16) steps
// The block's shared memory: the bf16 parts (x hi, x lo, w hi, w lo, each
// 64 deep: two halves, a step each), the ring of STAGES steps (an x step of
// 128 rows, then a w step of 32 k rows), a "full" mbarrier a stage.
constexpr int PART_X = S_BM * 64 * 2;                 // 16 KB
constexpr int PART_W = 64 * S_BN * 2;                 // 8 KB
constexpr int PARTS = 2 * PART_X + 2 * PART_W;        // 48 KB
constexpr int STAGE_X = S_BM * S_BK * 4;              // 16 KB
constexpr int STAGE = STAGE_X + S_BK * S_BN * 4;      // + 8 KB
constexpr int BARS = PARTS + STAGES * STAGE;
constexpr int S_SMEM = BARS + STAGES * 8 + 1024;      // + room to align to 1024
constexpr int CT = S_BN + 4;                          // row stride of the f32 partial tile
static_assert(S_BM * CT * 4 <= PARTS, "the partial tile must fit in the parts");
static_assert(2 * (S_SMEM + 1024) <= 233472, "two blocks a SM");

// First K step of split q when `units` steps are cut into `splits` near-equal
// runs, as analog_tc.cu's split_begin and analog_matmul.py split_ranges.
__host__ __device__ __forceinline__ int split_begin(int units, int splits, int q) {
  return (int)(((long long)q * units) / splits);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
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

__device__ __forceinline__ void st_shared_v2(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y) : "memory");
}

// byte offset of 16-byte chunk `chunk` of 128-byte row `row` in a
// 1024-aligned tile with the 128-byte swizzle (what TMA would write)
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (32 f32 a thread) += A (64 x 16, K-major) * B (16 x 64, MN-major)
__device__ __forceinline__ void wgmma_64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Box-Muller of one pair of Threefry words: the tail of counter_gaussian
// (analog_common.cuh), written out so the words of 4 draws are formed first.
__device__ __forceinline__ float box_muller(uint32_t b0, uint32_t b1) {
  const float u1 = 1.0f - (float)(b0 >> 8) * UNIT;  // (0, 1]: log finite
  const float u2 = (float)(b1 >> 8) * UNIT;
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(TWO_PI, u2)));
}

// xi at the counters (c0, c1 + c), c = 0..3: repeat_gaussian's streams and
// order (r = 0..n-1 summed in order, then * inv_k), the 4 Threefry chains of
// a repeat side by side.
__device__ __forceinline__ void gaussians4(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                                           int n_repeats, float inv_k, float* xi) {
  for (int r = 0; r < n_repeats; ++r) {
    const uint32_t k1r = k1 ^ ((uint32_t)r * REPEAT_STREAM_MULT);
    uint32_t b0[4], b1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) threefry2x32(k0, k1r, c0, c1 + (uint32_t)c, b0[c], b1[c]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float g = box_muller(b0[c], b1[c]);
      xi[c] = r == 0 ? g : __fadd_rn(xi[c], g);
    }
  }
  if (n_repeats > 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) xi[c] = __fmul_rn(xi[c], inv_k);
  }
}

// finish_output (analog_common.cuh) of columns c .. c + 3 of flattened row
// r: the same operations on each output, the row's request, seed words and
// row scale read once and the four draws side by side. Columns past N take
// column N - 1's scale; the caller does not store them.
__device__ __forceinline__ void finish4(const Params& p, int r, int c, float* y) {
  if (p.noise_kind == NOISE_OUTPUT) {
    const int b = r / p.M;
    const uint32_t* s = p.seed + 4 * b;
    float xi[4];
    gaussians4(s[0], s[1], s[2] + (uint32_t)(r - b * p.M), s[3] + (uint32_t)c, p.n_repeats,
               p.inv_k, xi);
    const float rs = p.rs[r];
    const float* cs = p.cs + (size_t)b * p.cs_stride;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      y[i] = __fadd_rn(y[i], __fmul_rn(__fmul_rn(rs, cs[min(c + i, p.N - 1)]), xi[i]));
  }
  if (p.quant_out) {
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = fake_quant(y[i], p.sc[3], p.sc[4], p.sc[5]);
  }
}

// Copies a ROWS x COLS tile of T into the ring at dst ([ROWS][COLS] T,
// row-major) where TMA cannot (rows not 16-byte multiples, or a base not
// 16-byte aligned): rows [0, ROWS) of a row-major source whose rows are `ld`
// elements apart, elements [c0, c0 + COLS) of each; rows >= nrows and

// Copies a ROWS x COLS tile of T into the ring at dst ([ROWS][COLS] T,
// row-major) where TMA cannot (a base or row stride that is not a 16-byte
// multiple): rows [0, ROWS) of a row-major source whose rows are `ld`
// elements apart, elements [c0, c0 + COLS) of each; rows >= nrows and
// elements >= climit read as zero. f32: 4-byte cp.async; bf16 (2-byte
// elements, no 4-byte copy aligned): plain loads.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* __restrict__ src, size_t ld,
                                          int nrows, int c0, int climit, int tid) {
  static_assert(ROWS * COLS % S_THREADS == 0, "whole copies a thread");
  if constexpr (sizeof(T) == 4) {
    const uint32_t d = smem_addr(dst);
#pragma unroll
    for (int it = 0; it < ROWS * COLS / S_THREADS; ++it) {
      const int e = tid + it * S_THREADS;
      const int r = e / COLS, c = c0 + e % COLS;
      const bool ok = r < nrows && c < climit;
      cp_async4(d + (uint32_t)e * 4, ok ? src + r * ld + c : src, ok ? 4 : 0);
    }
  } else {
    unsigned short* s = reinterpret_cast<unsigned short*>(dst);
    const unsigned short* g = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int it = 0; it < ROWS * COLS / S_THREADS; ++it) {
      const int e = tid + it * S_THREADS;
      const int r = e / COLS, c = c0 + e % COLS;
      s[e] = (r < nrows && c < climit) ? __ldg(g + r * ld + c) : (unsigned short)0;
    }
  }
}

template <typename T>
__device__ __forceinline__ void read4(const unsigned char* tile, int idx, float* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 t = *reinterpret_cast<const float4*>(tile + idx * 4);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(tile + idx * 2);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

// hi = bf16(v), lo = bf16(v - hi) of 4 values, each part packed in 8 bytes
__device__ __forceinline__ void split4(const float* v, uint2& hi, uint2& lo) {
  uint32_t h[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __nv_bfloat162 hh = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hh);
    const __nv_bfloat162 ll =
        __floats2bfloat162_rn(__fsub_rn(v[2 * i], hf.x), __fsub_rn(v[2 * i + 1], hf.y));
    h[i] = *reinterpret_cast<const uint32_t*>(&hh);
    l[i] = *reinterpret_cast<const uint32_t*>(&ll);
  }
  hi = make_uint2(h[0], h[1]);
  lo = make_uint2(l[0], l[1]);
}

// Output tile `unit` of the grid (request b under weight noise, row tile,
// column tile; column tiles fastest): rows [row_begin, row_end) of the
// flattened (B * M) rows, columns from col0.
struct Tile {
  long long row_begin, row_end;
  int col0, b;
};

__device__ __forceinline__ Tile unit_tile(const Params& p, long long unit, int row_tiles,
                                          int col_tiles) {
  Tile t;
  const long long rt = unit / col_tiles;
  t.col0 = (int)(unit - rt * col_tiles) * S_BN;
  if (p.noise_kind == NOISE_WEIGHT) {  // row tiles of one request
    t.b = (int)(rt / row_tiles);
    const long long first = (long long)t.b * p.M;
    t.row_begin = first + (rt - (long long)t.b * row_tiles) * S_BM;
    t.row_end = min(t.row_begin + S_BM, first + p.M);
  } else {
    t.b = 0;
    t.row_begin = rt * S_BM;
    t.row_end = min(t.row_begin + S_BM, (long long)p.B * p.M);
  }
  return t;
}

// w's values of one quad (k row k, columns j0 .. j0 + 3) as the reference
// forms them: quant_w, then the weight noise; zero outside K and N.
// w's values of one quad (k row k, columns j0 .. j0 + 3) as the reference
// forms them: quant_w, then the weight noise; zero outside K and N.
template <bool QW, bool NOISE>
__device__ __forceinline__ void weight_quad(const Params& p, int k, int j0, uint32_t wk0,
                                            uint32_t wk1, uint32_t wcol0, const float* wcs,
                                            float* v) {
  if (QW) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = min(j0 + c, p.N - 1);
      v[c] = fake_quant(v[c], p.wq[j], p.wq[p.N + j], p.wq[2 * p.N + j]);
    }
  }
  if (NOISE) {
    float xi[4];
    gaussians4(wk0, wk1, (uint32_t)k, wcol0 + (uint32_t)j0, p.n_repeats, p.inv_k, xi);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = __fadd_rn(v[c], __fmul_rn(wcs[min(j0 + c, p.N - 1)], xi[c]));
  }
  if (QW || NOISE) {  // the ring holds zeros there; a quantizer or the noise would not
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = (k < p.K && j0 + c < p.N) ? v[c] : 0.0f;
  }
}

// A persistent grid of clusters of `splits` blocks (one block a cluster when
// splits == 1): cluster i computes output tiles i, i + clusters, ... of the
// `units` tiles (128 x 64); rank q of each sums K steps
// [split_begin(k_steps, splits, q), ... (q + 1)). The ring runs on across
// tiles, so the next tile's first steps are in flight during a tile's
// epilogue. Both warpgroups copy, convert, multiply (each its 64 rows) and
// finish. T the
// operands' type, XLO / WLO whether x / w have a lo part, WN weight noise
// (tiles of one request each, the draws in the converting stage; without
// it no draw code weighs on the loop's registers). xtma / wtma: the
// operand comes by TMA (else by cp.async or loads).
template <typename T, bool XLO, bool WLO, bool WN>
__global__ void __launch_bounds__(S_THREADS, 2)
    simt_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                const Params p, int row_tiles, int col_tiles, int splits, int xtma, int wtma) {
  constexpr int WQ = S_BN / 4;  // quads of a w row
  extern __shared__ unsigned char ssmem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ssmem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t a_hi = smem_addr(smem), a_lo = a_hi + PART_X, b_hi = a_lo + PART_X,
                 b_lo = b_hi + PART_W;
  unsigned char* ring = smem + PARTS;
  const uint32_t full = smem_addr(smem + BARS);  // STAGES barriers: a stage's TMA bytes
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int wg = tid / 128;  // the warpgroup: rows 64 wg .. 64 wg + 63 of the tile
  const int q = (int)(blockIdx.x % (unsigned)splits);
  const long long cluster_id = blockIdx.x / (unsigned)splits;
  const long long clusters = gridDim.x / (unsigned)splits;
  const long long units =
      (long long)(p.noise_kind == NOISE_WEIGHT ? p.B : 1) * row_tiles * col_tiles;
  const long long my_units = units > cluster_id ? (units - cluster_id + clusters - 1) / clusters : 0;
  const int k_steps = (p.K + S_BK - 1) / S_BK;
  const int ks0 = split_begin(k_steps, splits, q);
  const int n_steps = split_begin(k_steps, splits, q + 1) - ks0;
  const float xd = p.sc[0], xz = p.sc[1], xbins = p.sc[2];

  // the copies run ahead of the products through the tiles' steps in order:
  // step pf_i of tile pf_ui into stage pf_stage; a group is committed even
  // when no step is left, so the group count stays uniform
  long long pf_left = my_units * n_steps, pf_ui = 0;
  int pf_i = 0, pf_stage = 0;
  Tile pf_t = unit_tile(p, cluster_id, row_tiles, col_tiles);
  auto issue = [&]() {
    if (pf_left > 0) {
      const int k0 = (ks0 + pf_i) * S_BK;
      unsigned char* st = ring + pf_stage * STAGE;
      const int nrows = (int)(pf_t.row_end - pf_t.row_begin);
      if (tid == 0 && (xtma || wtma)) {  // one thread: the TMA boxes, zero-filled past the edges
        const uint32_t bar = full + 8 * pf_stage;
        mbar_expect_tx(bar, (xtma ? S_BM * S_BK * sizeof(T) : 0) +
                                (wtma ? S_BK * S_BN * sizeof(T) : 0));
        if (xtma) tma_load_2d(smem_addr(st), &map_x, bar, k0, (int)pf_t.row_begin);
        if (wtma) tma_load_2d(smem_addr(st + STAGE_X), &map_w, bar, pf_t.col0, k0);
      }
      if (!xtma) {
        load_tile<T, S_BM, S_BK>(st, x + (size_t)pf_t.row_begin * p.K, (size_t)p.K, nrows, k0,
                                 p.K, tid);
      }
      if (!wtma) {
        load_tile<T, S_BK, S_BN>(st + STAGE_X, w + (size_t)k0 * p.ldw, (size_t)p.ldw, p.K - k0,
                               pf_t.col0, p.N, tid);
      }
      if (--pf_left > 0 && ++pf_i == n_steps) {
        pf_i = 0;
        pf_t = unit_tile(p, cluster_id + ++pf_ui * clusters, row_tiles, col_tiles);
      }
    }
    cp_async_commit();
    pf_stage = pf_stage + 1 == STAGES ? 0 : pf_stage + 1;
  };

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue();

  cg::cluster_group cluster = cg::this_cluster();
  // the ring stage of the next step, its barrier's phase, and the half of the parts
  int stage = 0, phase = 0, half = 0;
#pragma unroll 1
  for (long long ui = 0; ui < my_units; ++ui) {
    const Tile t = unit_tile(p, cluster_id + ui * clusters, row_tiles, col_tiles);
    const int nrows = (int)(t.row_end - t.row_begin);
    uint32_t wk0 = 0, wk1 = 0, wcol0 = 0;
    const float* wcs = p.cs;
    if (WN) {
      const uint32_t* s = p.seed + 4 * t.b;
      wk0 = s[0] ^ WEIGHT_STREAM_SALT;
      wk1 = s[1];
      wcol0 = s[3];
      wcs = p.cs + (size_t)t.b * p.cs_stride;
    }
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

#pragma unroll 1
    for (int i = 0; i < n_steps; ++i) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of the step have landed
      if (xtma || wtma) mbar_wait(full + 8 * stage, phase);  // and the step's TMA boxes
      // the products of the step before the last, which read this half of the parts
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      __syncthreads();  // every copy of the step visible; this half and the last stage free
      issue();
      const unsigned char* st = ring + stage * STAGE;
      const int k0 = (ks0 + i) * S_BK;
      // converting stage: 128 rows x 8 quads of 4 values of x (K-major), 32
      // k rows x 16 quads of w (MN-major)
#pragma unroll
      for (int it = 0; it < S_BM * 8 / S_THREADS; ++it) {
        const int e = tid + it * S_THREADS;
        const int r = e >> 3, qd = e & 7;
        float v[4];
        read4<T>(st, r * S_BK + qd * 4, v);
        if (XLO && p.quant_x) {  // zero outside the rows and K, as the ring holds there
#pragma unroll
          for (int c = 0; c < 4; ++c)
            v[c] = (r < nrows && k0 + qd * 4 + c < p.K) ? fake_quant(v[c], xd, xz, xbins) : 0.0f;
        }
        uint2 hi, lo;
        split4(v, hi, lo);
        const uint32_t off = swizzled(r, half * 4 + (qd >> 1)) + (qd & 1) * 8;
        st_shared_v2(a_hi + off, hi);
        if (XLO) st_shared_v2(a_lo + off, lo);
      }
#pragma unroll
      for (int it = 0; it < S_BK * WQ / S_THREADS; ++it) {
        const int e = tid + it * S_THREADS;
        const int kr = e / WQ, qd = e % WQ;
        const int k = k0 + kr, j0 = t.col0 + qd * 4;
        float v[4];
        read4<T>(st + STAGE_X, kr * S_BN + qd * 4, v);
        if (!WLO) {
          weight_quad<false, false>(p, k, j0, wk0, wk1, wcol0, wcs, v);
        } else if (WN) {
          if (p.quant_w) {
            weight_quad<true, true>(p, k, j0, wk0, wk1, wcol0, wcs, v);
          } else {
            weight_quad<false, true>(p, k, j0, wk0, wk1, wcol0, wcs, v);
          }
        } else if (p.quant_w) {
          weight_quad<true, false>(p, k, j0, wk0, wk1, wcol0, wcs, v);
        } else {
          weight_quad<false, false>(p, k, j0, wk0, wk1, wcol0, wcs, v);
        }
        uint2 hi, lo;
        split4(v, hi, lo);
        const uint32_t off = swizzled(half * S_BK + kr, qd >> 1) + (qd & 1) * 8;
        st_shared_v2(b_hi + off, hi);
        if (WLO) st_shared_v2(b_lo + off, lo);
      }
      // the parts, written by the threads, are read by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < S_BK / 16; ++s) {
        // x: K-major, this warpgroup's 64 rows 8 KB into the part, 8-row
        // groups 1024 bytes apart, k16 steps 32 bytes along the swizzled
        // row; w: MN-major, 8-row k groups 1024 bytes apart, k16 steps 16
        // rows of 128 bytes. hi*hi, then hi*lo, then lo*hi.
        const int ks = half * (S_BK / 16) + s;
        const uint64_t dxh = wgmma_desc(a_hi + wg * (64 * 128) + ks * 32, 16, 1024);
        const uint64_t dwh = wgmma_desc(b_hi + ks * 16 * 128, PART_W, 1024);
        wgmma_64(acc, dxh, dwh);
        if (WLO) wgmma_64(acc, dxh, wgmma_desc(b_lo + ks * 16 * 128, PART_W, 1024));
        if (XLO) wgmma_64(acc, wgmma_desc(a_lo + wg * (64 * 128) + ks * 32, 16, 1024), dwh);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      half ^= 1;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();  // every product of the tile done: the parts are free

    // accumulator fragment of m64n64: warp w of warpgroup wg holds rows 64 wg
    // + 16w + g and 16w + g + 8 (g = lane / 4); acc[4j + {0, 1}] at columns
    // 8j + 2t + {0, 1} of the first, acc[4j + {2, 3}] of the second (t = lane % 4)
    float* ct = reinterpret_cast<float*>(smem);  // [S_BM][CT] over the parts
    {
      const int wp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wg * 64 + wp * 16 + (lane >> 2) + h * 8;
          const int c = j * 8 + (lane & 3) * 2;
          *reinterpret_cast<float2*>(ct + r * CT + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
    }

    // the splits: rank q adds the cluster's partial tiles at its rows in
    // rank order and finishes them, 4 columns a thread
    if (splits > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    const int own = S_BM / splits;
    const bool quads = (p.N & 3) == 0;  // whole 16-byte rows of the output
#pragma unroll 1
    for (int e = tid; e < own * WQ; e += S_THREADS) {
      const int rl = q * own + e / WQ, cl = (e % WQ) * 4;
      const int c = t.col0 + cl;
      if (rl >= nrows || c >= p.N) continue;
      const int r = (int)(t.row_begin + rl);
      float* src = ct + rl * CT + cl;
      float4 y4 = *reinterpret_cast<const float4*>(src);
      if (splits > 1) {
        y4 = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, 0));
        for (int pr = 1; pr < splits; ++pr) {
          const float4 u = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, pr));
          y4 = make_float4(__fadd_rn(y4.x, u.x), __fadd_rn(y4.y, u.y), __fadd_rn(y4.z, u.z),
                           __fadd_rn(y4.w, u.w));
        }
      }
      float y[4] = {y4.x, y4.y, y4.z, y4.w};
      finish4(p, r, c, y);
      float* dst = p.out + (size_t)r * p.N + c;
      if (quads) {
        *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
        for (int i = 0; i < 4 && c + i < p.N; ++i) dst[i] = y[i];
      }
    }
    // no rank goes on while a peer may still read its tile
    if (splits > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

__global__ void threefry_words_kernel(uint32_t k0, uint32_t k1, uint32_t row0, uint32_t col0,
                                      int rows, int cols, uint32_t* out) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)rows * cols) return;
  const int i = (int)(idx / cols), j = (int)(idx % cols);
  uint32_t a, b;
  threefry2x32(k0, k1, row0 + (uint32_t)i, col0 + (uint32_t)j, a, b);
  out[2 * idx] = a;
  out[2 * idx + 1] = b;
}

// Launch simt_kernel<T, XLO, WLO, WN> over `units` output tiles: a
// persistent grid of as many clusters of `splits` blocks (one block when
// splits == 1) as the card holds at once, at most one a tile.
template <typename T, bool XLO, bool WLO, bool WN>
cudaError_t launch(const CUtensorMap& map_x, const CUtensorMap& map_w, const Params& p,
                   long long units, int row_tiles, int col_tiles, int splits, int xtma, int wtma,
                   cudaStream_t s) {
  static int resident[4] = {0, 0, 0, 0};  // clusters the card holds, by log2(splits)
  static bool ready = false;              // the shared memory limit is raised once a process
  auto kernel = simt_kernel<T, XLO, WLO, WN>;
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(S_THREADS);
  cfg.dynamicSmemBytes = S_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const int slot = splits == 1 ? 0 : splits == 2 ? 1 : splits == 4 ? 2 : 3;
  if (resident[slot] == 0) {
    int n = 0;
    cudaError_t e;
    if (splits > 1) {
      cfg.gridDim = dim3(splits);
      e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    } else {
      int dev = 0, sms = 0, per_sm = 0;
      e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, S_THREADS, S_SMEM);
      n = sms * per_sm;
    }
    if (e != cudaSuccess) return e;
    if (n <= 0) return cudaErrorInvalidConfiguration;
    resident[slot] = n;
  }
  const long long clusters = units < resident[slot] ? units : resident[slot];
  cfg.gridDim = dim3((unsigned)(clusters * splits));
  return cudaLaunchKernelEx(&cfg, kernel, map_x, map_w, p, row_tiles, col_tiles, splits, xtma,
                            wtma);
}

// The kernel for the call's flags.
cudaError_t launch_flags(const CUtensorMap& mx, const CUtensorMap& mw, const Params& p, int bf16,
                         long long u, int rt, int ct, int splits, int xtma, int wtma,
                         cudaStream_t s) {
  using B16 = __nv_bfloat16;
  const bool wn = p.noise_kind == NOISE_WEIGHT;
  if (!bf16) {
    if (wn) return launch<float, true, true, true>(mx, mw, p, u, rt, ct, splits, xtma, wtma, s);
    return launch<float, true, true, false>(mx, mw, p, u, rt, ct, splits, xtma, wtma, s);
  }
  if (wn && p.quant_x)
    return launch<B16, true, true, true>(mx, mw, p, u, rt, ct, splits, xtma, wtma, s);
  if (wn) return launch<B16, false, true, true>(mx, mw, p, u, rt, ct, splits, xtma, wtma, s);
  if (p.quant_x && p.quant_w)
    return launch<B16, true, true, false>(mx, mw, p, u, rt, ct, splits, xtma, wtma, s);
  if (p.quant_x) return launch<B16, true, false, false>(mx, mw, p, u, rt, ct, splits, xtma, wtma, s);
  if (p.quant_w) return launch<B16, false, true, false>(mx, mw, p, u, rt, ct, splits, xtma, wtma, s);
  return launch<B16, false, false, false>(mx, mw, p, u, rt, ct, splits, xtma, wtma, s);
}

bool aligned16(const void* ptr, long long row_bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && row_bytes % 16 == 0;
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

// 2-D map of a row-major (outer, inner) array of f32 or bf16 whose rows are
// `ld` elements apart (ld >= inner: a column shard of a wider array), box
// (box_outer, box_inner), no swizzle (the ring is read by the threads);
// out-of-bounds elements (past `inner` too) read as zero.
bool make_map(CUtensorMap* map, const void* base, int bf16, long long outer, long long inner,
              long long ld, int box_outer, int box_inner) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t es = bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * es};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Launch on `stream`; returns the first CUDA error (0 on success). x and w
// are both bf16 (bf16 != 0) or both f32; w's rows are ldw elements apart (N
// for a whole weight, the whole N for a column shard). row_tiles (of 128
// rows of B * M, or of M a request under weight noise), col_tiles of 64 and
// the splits of K's 32-deep steps (1, 2, 4 or 8) come from simt_plan in
// analog_matmul.py.
extern "C" int analog_matmul_launch(const void* x, const void* w, int bf16, const float* rs,
                                    const float* cs, int cs_stride, const float* wq,
                                    const float* sc, const uint32_t* seed, float* out, int B,
                                    int M, int K, int N, int ldw, int noise_kind, int quant_x,
                                    int quant_w, int quant_out, int n_repeats, float inv_k,
                                    int row_tiles, int col_tiles, int splits, void* stream) {
  const Params p = make_params(x, w, rs, cs, cs_stride, wq, sc, seed, out, B, M, K, N, ldw,
                               noise_kind, quant_x, quant_w, quant_out, n_repeats, inv_k);
  const long long k_steps = (K + S_BK - 1) / S_BK;
  if (splits < 1 || splits > 8 || (splits & (splits - 1)) != 0 || (k_steps > 0 && k_steps < splits))
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)(noise_kind == NOISE_WEIGHT ? B : 1) * row_tiles * col_tiles;
  if (units <= 0) return (int)cudaErrorInvalidValue;
  // TMA where the rows are 16-byte multiples and the base 16-byte aligned
  const int es = bf16 ? 2 : 4;
  const int xtma = K > 0 && aligned16(x, (long long)K * es);
  const int wtma = K > 0 && aligned16(w, (long long)ldw * es);
  CUtensorMap map_x = {}, map_w = {};
  if ((xtma && !make_map(&map_x, x, bf16, (long long)B * M, K, K, S_BM, S_BK)) ||
      (wtma && !make_map(&map_w, w, bf16, K, N, ldw, S_BK, S_BN)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = launch_flags(map_x, map_w, p, bf16, units, row_tiles, col_tiles, splits,
                                     xtma, wtma, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Raw Threefry words for the counter grid (row0 + i, col0 + j), written as
// out[(i * cols + j) * 2 + {0, 1}]. Exists so a check can hold the device
// Threefry bit-exactly against the plain version.
extern "C" int threefry_words(uint32_t k0, uint32_t k1, uint32_t row0, uint32_t col0, int rows,
                              int cols, uint32_t* out, void* stream) {
  const long n = (long)rows * cols;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  threefry_words_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, row0, col0, rows, cols, out);
  return (int)cudaGetLastError();
}
