// Route "simt" of the analog matmul for Hopper (sm_90a): the PR 11 kernel,
// plain C entry points for ctypes.
//
// Replaces the Pallas TPU kernel `_kernel` / `analog_matmul_raw` of
// src/repro/kernels/analog_matmul.py (pallas_call at line 208) and the
// in-register noise of src/repro/kernels/prng.py, for what the two faster
// routes do not take (src/repro_torch/kernels/analog_matmul.py select_route):
// noise_kind == weight, f32 operands, quant_x / quant_w above M_DECODE rows,
// rows not a multiple of 16 bytes. Per output element it computes, in
// this order:
//   1. optional per-tensor fake-quant of x            (scalars[0:3])
//   2. optional per-channel fake-quant of w           (wq rows: delta, zp, bins)
//   3. noise_kind == weight: w += cs[j] * xi(k, col0 + j), key k0 ^ SALT
//   4. the f32 accumulate over K, ragged K/M/N edges masked
//   5. noise_kind == output: y += rs[i] * cs[j] * xi(row0 + i, col0 + j)
//   6. optional output fake-quant                     (scalars[3:6])
// xi is the mean of n_repeats Threefry-2x32-20 / Box-Muller streams whose k1
// is xor-ed with r * 0x85EBCA6B (analog_common.cuh). The noise tensor never
// exists in memory.
//
// One launch serves a whole bucket batch. x is (B, M, K) flattened to B*M
// rows; each row carries its request index b = row / M and reads request
// b's seed words (k0, k1, row0, col0), row scale and col scale (col scale
// stride 0 when it is shared), and uses its local row index as the noise
// counter, so every request draws exactly what it would draw alone. For
// output/none noise a block spans rows of several requests. Weight noise
// makes the noisy w tile differ per request, so for that kind grid.z runs
// over requests and a block never mixes them.
//
// Bound on the H100: with noisy weights (not bf16-exact) or f32 operands
// the product runs at the f32 SIMT rate (67 TFLOP/s), which bounds it at
// prefill shapes; at decode the weight bytes (3.35 TB/s) do. The design is
// deliberately simple: 64x64 output tiles, 16-deep K steps through shared
// memory, 4x4 outputs per thread, f32 sums in registers. It is also the
// yardstick the decode and tc routes are timed against.

#include "analog_common.cuh"

namespace {

using namespace analog;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int TM = 4;
constexpr int TN = 4;

template <typename T>
__global__ void __launch_bounds__(THREADS) analog_mm_kernel(const Params p) {
  __shared__ float As[BK][BM + 1];  // +1: conflict-free transposed stores
  __shared__ float Bs[BK][BN];
  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ w = static_cast<const T*>(p.w);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int col_base = blockIdx.x * BN;

  // rows [row_begin, row_end) of the flattened (B * M) row space
  const bool per_req = p.noise_kind == NOISE_WEIGHT;
  int row_begin, row_end;
  if (per_req) {
    row_begin = blockIdx.z * p.M + blockIdx.y * BM;
    row_end = min(row_begin + BM, (int)(blockIdx.z + 1) * p.M);
  } else {
    row_begin = blockIdx.y * BM;
    row_end = min(row_begin + BM, p.B * p.M);
  }

  uint32_t wk0 = 0, wk1 = 0, wcol0 = 0;
  const float* wcs = p.cs;
  if (per_req) {
    const uint32_t* s = p.seed + 4 * blockIdx.z;
    wk0 = s[0] ^ WEIGHT_STREAM_SALT;
    wk1 = s[1];
    wcol0 = s[3];
    wcs = p.cs + (size_t)blockIdx.z * p.cs_stride;
  }
  const float xd = p.sc[0], xz = p.sc[1], xbins = p.sc[2];

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int kk = e % BK, rr = e / BK;
      const int r = row_begin + rr, k = k0 + kk;
      float v = 0.0f;
      if (r < row_end && k < p.K) {
        v = to_f32(x[(size_t)r * p.K + k]);
        if (p.quant_x) v = fake_quant(v, xd, xz, xbins);
      }
      As[kk][rr] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int jj = e % BN, kk = e / BN;
      const int j = col_base + jj, k = k0 + kk;
      float v = 0.0f;
      if (j < p.N && k < p.K) {
        v = to_f32(w[(size_t)k * p.ldw + j]);
        if (p.quant_w) v = fake_quant(v, p.wq[j], p.wq[p.N + j], p.wq[2 * p.N + j]);
        if (per_req) {
          const float xi = repeat_gaussian(wk0, wk1, (uint32_t)k, wcol0 + (uint32_t)j,
                                           p.n_repeats, p.inv_k);
          v = __fadd_rn(v, __fmul_rn(wcs[j], xi));
        }
      }
      Bs[kk][jj] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float od = p.sc[3], oz = p.sc[4], obins = p.sc[5];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row_begin + ty + 16 * i;
    if (r >= row_end) continue;
    const int b = r / p.M;
    const uint32_t li = (uint32_t)(r - b * p.M);
    const uint32_t* s = p.seed + 4 * b;
    const float rsv = p.rs[r];
    const float* csb = p.cs + (size_t)b * p.cs_stride;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col_base + tx + 16 * j;
      if (c >= p.N) continue;
      float y = acc[i][j];
      if (p.noise_kind == NOISE_OUTPUT) {
        const float xi = repeat_gaussian(s[0], s[1], s[2] + li, s[3] + (uint32_t)c,
                                         p.n_repeats, p.inv_k);
        y = __fadd_rn(y, __fmul_rn(__fmul_rn(rsv, csb[c]), xi));
      }
      if (p.quant_out) y = fake_quant(y, od, oz, obins);
      p.out[(size_t)r * p.N + c] = y;
    }
  }
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

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x and w are both bf16 (bf16 != 0) or both f32; w's rows are ldw elements
// apart (N for a whole weight, the full N for a column shard).
extern "C" int analog_matmul_launch(const void* x, const void* w, int bf16, const float* rs,
                                    const float* cs, int cs_stride, const float* wq, const float* sc, const uint32_t* seed,
                                    float* out, int B, int M, int K, int N, int ldw, int noise_kind,
                                    int quant_x, int quant_w, int quant_out, int n_repeats,
                                    float inv_k, void* stream) {
  const Params p = make_params(x, w, rs, cs, cs_stride, wq, sc, seed, out, B, M, K, N, ldw,
                               noise_kind, quant_x, quant_w, quant_out, n_repeats, inv_k);
  const bool per_req = noise_kind == NOISE_WEIGHT;
  const dim3 grid((N + BN - 1) / BN, per_req ? (M + BM - 1) / BM : (B * M + BM - 1) / BM,
                  per_req ? B : 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    analog_mm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(p);
  } else {
    analog_mm_kernel<float><<<grid, THREADS, 0, s>>>(p);
  }
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
