// Route "weight" of the analog matmul for Hopper (sm_90a): weight noise on
// bf16 x and w whose rows are 16-byte multiples. Plain C entry points for
// ctypes.
//
// Replaces, for these calls, the weight-noise branch of the Pallas TPU
// kernel `_kernel` of src/repro/kernels/analog_matmul.py (lines 108-121,
// pallas_call at line 208) with prng.py repeat_averaged_gaussian_tile
// (line 114). For request b, row i, column j:
//   y[b,i,j] = sum_k x[b,i,k] * (wq(w[k,j]) + cs_b[j] * xi_b(k, col0_b + j))
// xi_b is the mean of n_repeats Threefry-2x32-20 / Box-Muller streams keyed
// (k0 ^ WEIGHT_STREAM_SALT, k1 ^ r * REPEAT_STREAM_MULT) at the global
// counters (k, col0 + j), summed for r = 0..K-1 in order and scaled by
// f32(1/K) (analog_common.cuh); optional output requant follows.
//
// Bound on the H100 (SXM spec at 700 W, not measured): the noise draws, not
// the bytes. A call draws B * K * N * n_repeats gaussians (decode gate/up, 2
// requests: 104.9 M) and reads W once a request (105 MB there, 31 us at
// 3.35 TB/s). A draw is 72 integer ops (20 rounds of add, rotate, xor; 5 key
// injections of 2 adds; 2 counter adds), which only the 64 INT32 lanes and
// the 64 FP32 lanes that issue IMAD of an SM can run: 72 / 128 lane-clocks
// a draw, 2.15 ps on 132 SMs at 1.98 GHz, 0.23 ms at decode gate/up;
// Box-Muller's 2 conversions and logf / sqrtf / cosf on the 16 SFU lanes
// take less. So the design serves the draw rate:
//   * every xi_b(k, j) is drawn once a request and call: a block holds all
//     of one request's rows (M <= 64 on the main path), never a tile of
//     rows that would draw it again;
//   * blocks of 128 threads (one warpgroup), 64 columns and a slice of kc
//     rows of K; the split of K depends on (K, N) alone (analog_matmul.py
//     weight_plan) and gives every granite-3-8b site at least two waves of
//     4 blocks a SM; the slices' partial sums go to a workspace and a second
//     kernel adds them in a fixed order, so a request's rows are the same
//     bits alone or in any batch, and from launch to launch;
//   * a thread draws 8 neighbouring columns of one k row (one 16-byte
//     weight load): the 8 Threefry chains run side by side before their
//     Box-Muller, so the 20-round chain does not stall the integer pipe;
//   * decode (M <= 2 rows a request): generate-and-dot on the SIMT units,
//     x in shared memory, M * 8 f32 accumulators a thread, no wasted row;
//   * prefill (more rows): v = wq(w) + cs * xi in f32, exactly as the
//     reference forms it, split into hi = bf16(v) and lo = bf16(v - hi),
//     written to shared memory in wgmma's 128-byte-swizzled layout; the
//     warpgroup runs wgmma m64n64k16 of the bf16 x rows against hi and
//     against lo into one f32 accumulator (32 registers a thread: two
//     spilled at the 128 registers that 4 blocks a SM leave). bf16 x bf16
//     products are exact in f32 and hi + lo keeps v to about 2^-17, so
//     the product stays within the reference's rule (tests/test_torch_
//     routes.py holds the arithmetic on the CPU). The tensor cores take the
//     product (~3 % of a tile's draw time) on two tile buffers: a tile's
//     wgmma runs while the warps draw the next tile into the other buffer.
// IEEE logf / sqrtf / cosf (no --use_fast_math): the gaussians match the
// plain version's within GAUSS_ATOL. cosf's slow path for large arguments
// (never taken: 2 pi u2 < 2 pi) keeps a local array; ptxas reports it as
// the stack frame.
//
// weight_draw_sum draws and sums xi over a grid with the same code: the
// measured ceiling of the draws, a check, not a path of the model.

#include "analog_common.cuh"

namespace {

using namespace analog;

constexpr int W_THREADS = 128;                // one warpgroup
constexpr int W_BN = 64;                      // columns a block
constexpr int W_CPT = 8;                      // columns a thread draws together (16 bytes)
constexpr int W_TPC = W_BN / W_CPT;           // 8 threads across a k row
constexpr int W_KL = W_THREADS / W_TPC;       // decode: 16 k lanes
constexpr int W_MIN_BLOCKS = 4;               // blocks a SM (weight_plan's wave)
constexpr int W_KC_MAX = 2048;                // rows of K a block at most
constexpr int P_BM = 64;                      // prefill: rows of a tile (wgmma m64)
constexpr int P_BK = 64;                      // prefill: K depth of a tile (128 bytes of bf16)
constexpr int P_TILE = P_BM * P_BK * 2;       // 8 KB: the x tile, and each of hi / lo (64 k x 64 n)
constexpr int P_STAGE = 3 * P_TILE;           // 24 KB: x, hi, lo
constexpr int P_SMEM = 2 * P_STAGE + 1024;    // two stages + room to align to 1024 (the swizzle atom)

// Box-Muller of one pair of Threefry words: the tail of counter_gaussian
// (analog_common.cuh), written out so the words of 8 draws are formed first.
__device__ __forceinline__ float box_muller(uint32_t b0, uint32_t b1) {
  const float u1 = 1.0f - (float)(b0 >> 8) * UNIT;  // (0, 1]: log finite
  const float u2 = (float)(b1 >> 8) * UNIT;
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(TWO_PI, u2)));
}

// xi at the counters (k, c1 + c), c = 0..7: repeat_gaussian's streams and
// order (r = 0..n-1 summed in order, then * inv_k), the 8 Threefry chains of
// a repeat side by side.
__device__ __forceinline__ void gaussians8(uint32_t k0, uint32_t k1, uint32_t k, uint32_t c1,
                                           int n_repeats, float inv_k, float* xi) {
  for (int r = 0; r < n_repeats; ++r) {
    const uint32_t k1r = k1 ^ ((uint32_t)r * REPEAT_STREAM_MULT);
    uint32_t b0[W_CPT], b1[W_CPT];
#pragma unroll
    for (int c = 0; c < W_CPT; ++c) threefry2x32(k0, k1r, k, c1 + (uint32_t)c, b0[c], b1[c]);
#pragma unroll
    for (int c = 0; c < W_CPT; ++c) {
      const float g = box_muller(b0[c], b1[c]);
      xi[c] = r == 0 ? g : __fadd_rn(xi[c], g);
    }
  }
  if (n_repeats > 1) {
#pragma unroll
    for (int c = 0; c < W_CPT; ++c) xi[c] = __fmul_rn(xi[c], inv_k);
  }
}

__device__ __forceinline__ void unpack8(const uint4 v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The request's draw: seed words and col scale of request b.
struct Stream {
  uint32_t k0, k1, col0;
  const float* cs;
};

__device__ __forceinline__ Stream request_stream(const Params& p, int b) {
  const uint32_t* s = p.seed + 4 * b;
  return Stream{s[0] ^ WEIGHT_STREAM_SALT, s[1], s[3], p.cs + (size_t)b * p.cs_stride};
}

// v[c] = wq(w[k, col + c]) + cs[col + c] * xi(k, col0 + col + c), as the
// reference forms it (no contraction).
template <bool QW>
__device__ __forceinline__ void noisy8(const Params& p, const Stream& st, const float* cs8,
                                       const float* qd, const float* qz, const float* qb,
                                       uint4 raw, int k, int col, float* v) {
  unpack8(raw, v);
  if (QW) {
#pragma unroll
    for (int c = 0; c < W_CPT; ++c) v[c] = fake_quant(v[c], qd[c], qz[c], qb[c]);
  }
  float xi[W_CPT];
  gaussians8(st.k0, st.k1, (uint32_t)k, st.col0 + (uint32_t)col, p.n_repeats, p.inv_k, xi);
#pragma unroll
  for (int c = 0; c < W_CPT; ++c) v[c] = __fadd_rn(v[c], __fmul_rn(cs8[c], xi[c]));
}

// ---------------------------------------------------------------------------
// decode: grid (col tiles, splits, B); 8 column threads x 16 k lanes
// ---------------------------------------------------------------------------

template <int MR, bool QW>
__global__ void __launch_bounds__(W_THREADS, W_MIN_BLOCKS)
    weight_decode_kernel(const Params p, int kc, float* __restrict__ ws) {
  __shared__ __align__(16) float sm[W_KC_MAX * MR];  // x slice [kc][MR], then the lane sums
  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(p.x);
  const uint4* __restrict__ wg = static_cast<const uint4*>(p.w);
  const int tid = threadIdx.x;
  const int tc = tid % W_TPC, tk = tid / W_TPC;
  const int b = blockIdx.z;
  const int col_base = blockIdx.x * W_BN;
  const int col = col_base + tc * W_CPT;
  const int split = blockIdx.y;
  const int k_begin = split * kc;
  const int klen = min(kc, p.K - k_begin);
  const int rows = p.B * p.M;
  const int row0 = b * p.M;
  const Stream st = request_stream(p, b);

  const float xd = p.sc[0], xz = p.sc[1], xbins = p.sc[2];
  for (int e = tid; e < MR * klen; e += W_THREADS) {
    const int r = e / klen, kk = e - r * klen;
    float v = 0.0f;
    if (r < p.M) {
      v = to_f32(x[(size_t)(row0 + r) * p.K + k_begin + kk]);
      if (p.quant_x) v = fake_quant(v, xd, xz, xbins);
    }
    sm[kk * MR + r] = v;
  }

  const bool col_ok = col < p.N;  // N % 8 == 0: a thread's columns are all in or all out
  float cs8[W_CPT], qd[W_CPT], qz[W_CPT], qb[W_CPT];
#pragma unroll
  for (int c = 0; c < W_CPT; ++c) {
    const int j = col_ok ? col + c : 0;
    cs8[c] = st.cs[j];
    if (QW) {
      qd[c] = p.wq[j];
      qz[c] = p.wq[p.N + j];
      qb[c] = p.wq[2 * p.N + j];
    }
  }
  float acc[MR][W_CPT];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int c = 0; c < W_CPT; ++c) acc[r][c] = 0.0f;
  __syncthreads();

  const size_t nq = (size_t)p.ldw / W_CPT;  // a weight row's stride in 16-byte loads
  const uint4* wp = wg + (size_t)k_begin * nq + (col_ok ? col / W_CPT : 0);
  uint4 next = (col_ok && tk < klen) ? __ldg(wp + (size_t)tk * nq) : make_uint4(0, 0, 0, 0);
  for (int kk = tk; kk < klen; kk += W_KL) {
    const uint4 cur = next;
    if (col_ok && kk + W_KL < klen) next = __ldg(wp + (size_t)(kk + W_KL) * nq);
    if (col_ok) {
      float v[W_CPT];
      noisy8<QW>(p, st, cs8, qd, qz, qb, cur, k_begin + kk, col, v);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float xv = sm[kk * MR + r];
#pragma unroll
        for (int c = 0; c < W_CPT; ++c) acc[r][c] = fmaf(xv, v[c], acc[r][c]);
      }
    }
  }

  // the 16 k lanes added in lane order through shared memory
  __syncthreads();  // the x slice is consumed
  float* red = sm;  // [W_KL][MR][W_BN]
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    float4* dst = reinterpret_cast<float4*>(red + (tk * MR + r) * W_BN + tc * W_CPT);
    dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  __syncthreads();
  for (int e = tid; e < MR * W_BN; e += W_THREADS) {
    const int r = e / W_BN, j = e - r * W_BN;
    const int c = col_base + j;
    if (r >= p.M || c >= p.N) continue;
    float s = red[r * W_BN + j];
#pragma unroll
    for (int l = 1; l < W_KL; ++l) s = __fadd_rn(s, red[(l * MR + r) * W_BN + j]);
    ws[((size_t)split * rows + row0 + r) * p.N + c] = s;
  }
}

// ---------------------------------------------------------------------------
// prefill: grid (col tiles, splits, B * row tiles); one warpgroup, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
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

// hi = bf16(v), lo = bf16(v - hi) for 8 values, packed as 16 bytes each
__device__ __forceinline__ void split8(const float* v, uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hh = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 hf = __bfloat1622float2(hh);
    const __nv_bfloat162 ll =
        __floats2bfloat162_rn(__fsub_rn(v[2 * i], hf.x), __fsub_rn(v[2 * i + 1], hf.y));
    h[i] = *reinterpret_cast<const uint32_t*>(&hh);
    l[i] = *reinterpret_cast<const uint32_t*>(&ll);
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

__global__ void __launch_bounds__(W_THREADS, W_MIN_BLOCKS)
    weight_prefill_kernel(const Params p, int kc, int row_tiles, float* __restrict__ ws) {
  extern __shared__ unsigned char wsmem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wsmem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_addr(smem);  // stage s: x at ring + s * P_STAGE, then hi, lo
  const uint4* __restrict__ xg = static_cast<const uint4*>(p.x);
  const uint4* __restrict__ wg = static_cast<const uint4*>(p.w);
  const int tid = threadIdx.x;
  const int b = blockIdx.z / row_tiles, rt = blockIdx.z - b * row_tiles;
  const int col_base = blockIdx.x * W_BN;
  const int split = blockIdx.y;
  const int k_begin = split * kc;
  const int klen = min(kc, p.K - k_begin);
  const int rows = p.B * p.M;
  const int nrows = min(P_BM, p.M - rt * P_BM);        // this tile's rows of request b
  const size_t xrow0 = (size_t)b * p.M + rt * P_BM;    // its first row in (B * M)
  const Stream st = request_stream(p, b);

  const int c8 = tid % W_TPC;  // 16-byte chunk of a 128-byte row: 8 k of x, 8 columns of w
  const int r0 = tid / W_TPC;  // rows r0 + 16 j, j = 0..3, of the x and w tiles
  const int col = col_base + c8 * W_CPT;
  const bool col_ok = col < p.N;
  float cs8[W_CPT];
#pragma unroll
  for (int c = 0; c < W_CPT; ++c) cs8[c] = st.cs[col_ok ? col + c : 0];
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  const size_t kq = (size_t)p.K / 8, nq = (size_t)p.ldw / W_CPT;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  // weight chunk of the tile's row r0 + 16 j (zero beyond the slice or N)
  auto w_chunk = [&](int k0, int j) {
    const int kr = k0 + r0 + 16 * j;
    return (col_ok && kr < klen) ? __ldg(wg + (size_t)(k_begin + kr) * nq + col / W_CPT) : zero;
  };
  uint4 next = w_chunk(0, 0);
  for (int k0 = 0, t = 0; k0 < klen; k0 += P_BK, ++t) {
    const uint32_t a_s = ring + (t & 1) * P_STAGE, hi_s = a_s + P_TILE, lo_s = hi_s + P_TILE;
    // x rows r0 + 16 j, k chunk c8 (K % 8 == 0: a chunk is all in or all
    // out), loaded now and stored after the draws, which hide the loads
    uint4 xv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = r0 + 16 * j, kk = k0 + c8 * 8;
      xv[j] = (i < nrows && kk < klen) ? __ldg(xg + (xrow0 + i) * kq + (k_begin + kk) / 8) : zero;
    }
    // this stage was last read by the products of tile t - 2: every warp
    // has waited for them (wait_group 1 after tile t - 1)
    __syncthreads();
    // one copy of the draw code (unrolled 4 times it would crowd the
    // instruction cache); the next row's weights, or the next tile's first
    // row's, load during this row's draws
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
      const uint4 cur = next;
      next = j < 3 ? w_chunk(k0, j + 1) : w_chunk(k0 + P_BK, 0);
      const int kr = r0 + 16 * j;
      uint4 hi = zero, lo = zero;
      if (col_ok && k0 + kr < klen) {
        float v[W_CPT];
        noisy8<false>(p, st, cs8, nullptr, nullptr, nullptr, cur, k_begin + k0 + kr, col, v);
        split8(v, hi, lo);
      }
      st_shared_v4(hi_s + swizzled(kr, c8), hi);
      st_shared_v4(lo_s + swizzled(kr, c8), lo);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) st_shared_v4(a_s + swizzled(r0 + 16 * j, c8), xv[j]);
    // the tiles, written by the threads, are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < P_BK / 16; ++ks) {
      // x: K-major, 8-row groups 1024 bytes apart, k16 steps 32 bytes along
      // the swizzled row; hi / lo: MN-major, 8-row k groups 1024 bytes
      // apart, k16 steps 16 rows of 128 bytes
      const uint64_t da = wgmma_desc(a_s + ks * 32, 16, 1024);
      wgmma_64(acc, da, wgmma_desc(hi_s + ks * 16 * 128, P_TILE, 1024));
      wgmma_64(acc, da, wgmma_desc(lo_s + ks * 16 * 128, P_TILE, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the products of tile t - 1 are done; those of tile t run on while
    // the next tile is drawn
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // accumulator fragment of m64n64: warp w holds rows 16w + g and 16w + g + 8
  // (g = lane / 4); acc[4j + {0, 1}] at columns 8j + 2t + {0, 1} of the
  // first, acc[4j + {2, 3}] of the second (t = lane % 4)
  const int w = tid / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w * 16 + (lane >> 2) + h * 8;
      const int c = col_base + j * 8 + (lane & 3) * 2;
      if (r < nrows && c < p.N) {
        const int a = 4 * j + 2 * h;
        *reinterpret_cast<float2*>(ws + ((size_t)split * rows + xrow0 + r) * p.N + c) =
            make_float2(acc[a], acc[a + 1]);
      }
    }
}

// the draws alone: each thread sums xi over 8-column units of a (K, N) grid
__global__ void __launch_bounds__(W_THREADS, W_MIN_BLOCKS)
    weight_draw_kernel(uint32_t k0, uint32_t k1, int K, int N, int n_repeats, float inv_k,
                       float* __restrict__ out) {
  const long units = (long)K * (N / W_CPT);
  const long stride = (long)gridDim.x * W_THREADS;
  const long t = (long)blockIdx.x * W_THREADS + threadIdx.x;
  float s = 0.0f;
  for (long u = t; u < units; u += stride) {
    const int k = (int)(u / (N / W_CPT));
    const int col = (int)(u - (long)k * (N / W_CPT)) * W_CPT;
    float xi[W_CPT];
    gaussians8(k0, k1, (uint32_t)k, (uint32_t)col, n_repeats, inv_k, xi);
#pragma unroll
    for (int c = 0; c < W_CPT; ++c) s += xi[c];
  }
  out[t] = s;
}

template <int MR>
cudaError_t launch_decode(const Params& p, int kc, int splits, int col_tiles, float* ws,
                          cudaStream_t s) {
  const dim3 grid(col_tiles, splits, p.B);
  if (p.quant_w) {
    weight_decode_kernel<MR, true><<<grid, W_THREADS, 0, s>>>(p, kc, ws);
  } else {
    weight_decode_kernel<MR, false><<<grid, W_THREADS, 0, s>>>(p, kc, ws);
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the first CUDA error (0 on success). x and w
// bf16, K % 8 == 0, N % 8 == 0, x and w 16-byte aligned, w's rows ldw
// elements apart (ldw % 8 == 0; a column shard's split of K is the whole
// weight's), kc <= 2048. The
// plan (kc, splits, col_tiles of 64, row_tiles of 64 rows; row_tiles == 0
// takes the decode kernel, for M <= 2) comes from weight_plan in
// analog_matmul.py; ws holds splits * B * M * N floats. quant_x and quant_w
// only with the decode kernel.
extern "C" int analog_weight_launch(const void* x, const void* w, const float* rs,
                                    const float* cs, int cs_stride, const float* wq,
                                    const float* sc, const uint32_t* seed, float* out, float* ws,
                                    int B, int M, int K, int N, int ldw, int quant_x, int quant_w,
                                    int quant_out, int n_repeats, float inv_k, int kc, int splits,
                                    int col_tiles, int row_tiles, void* stream) {
  const Params p = make_params(x, w, rs, cs, cs_stride, wq, sc, seed, out, B, M, K, N, ldw,
                               NOISE_WEIGHT, quant_x, quant_w, quant_out, n_repeats, inv_k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kc <= 0 || kc > W_KC_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (row_tiles == 0) {
    switch (M) {
      case 1: e = launch_decode<1>(p, kc, splits, col_tiles, ws, s); break;
      case 2: e = launch_decode<2>(p, kc, splits, col_tiles, ws, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    if (quant_x || quant_w) return (int)cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(weight_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P_SMEM);
    if (e != cudaSuccess) return (int)e;
    weight_prefill_kernel<<<dim3(col_tiles, splits, B * row_tiles), W_THREADS, P_SMEM, s>>>(
        p, kc, row_tiles, ws);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  // the splits added in a fixed order, then requant (weight noise is in the sums)
  splits_finish_kernel<<<dim3((N + 31) / 32, B * M), F_LANES * 32, 0, s>>>(p, splits, ws);
  return (int)cudaGetLastError();
}

// xi over the (K, N) counter grid of key (k0, k1), n_repeats streams, summed
// per thread into out[blocks * 128]. N % 8 == 0.
extern "C" int weight_draw_sum(uint32_t k0, uint32_t k1, int K, int N, int n_repeats, float inv_k,
                               int blocks, float* out, void* stream) {
  weight_draw_kernel<<<blocks, W_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, K, N, n_repeats, inv_k, out);
  return (int)cudaGetLastError();
}
