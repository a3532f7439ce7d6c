// Shared by every route of the analog matmul (analog_matmul.cu = simt,
// analog_decode.cu = decode, analog_tc.cu = tc, analog_weight.cu = weight):
// the operand struct, the Threefry-2x32-20 / Box-Muller noise of
// src/repro/kernels/prng.py, the fake quantizer, the output epilogue and
// the second pass of the split-K routes. Every route draws its noise
// through these functions at global (row, col) counters, so a result does
// not depend on which route or tiling produced it.
//
// Build without --use_fast_math: logf/cosf/sqrtf and division must be the
// IEEE versions for the gaussians to match the reference to a few ulp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace analog {

constexpr int NOISE_NONE = 0;
constexpr int NOISE_OUTPUT = 1;
constexpr int NOISE_WEIGHT = 2;

constexpr uint32_t PARITY = 0x1BD11BDAu;
constexpr uint32_t WEIGHT_STREAM_SALT = 0x9E3779B9u;
constexpr uint32_t REPEAT_STREAM_MULT = 0x85EBCA6Bu;
constexpr float UNIT = 5.9604644775390625e-8f;  // 2^-24
constexpr float TWO_PI = 0x1.921fb6p+2f;        // float32(2.0 * 3.14159265358979)

struct Params {
  const void* x;
  const void* w;
  const float* rs;        // (B * M)
  const float* cs;        // (B or 1, N)
  const float* wq;        // (3, N)
  const float* sc;        // (8)
  const uint32_t* seed;   // (B, 4)
  float* out;             // (B * M, N)
  int B, M, K, N;
  int ldw;                // row stride of w in elements: N, or the whole
                          // weight's N for a column shard (a view)
  int cs_stride;          // N, or 0 when the col scale is shared
  int noise_kind;
  int quant_x, quant_w, quant_out;
  int n_repeats;
  float inv_k;            // float32(1 / n_repeats), rounded on the host
};

inline Params make_params(const void* x, const void* w, const float* rs, const float* cs,
                          int cs_stride, const float* wq, const float* sc, const uint32_t* seed,
                          float* out, int B, int M, int K, int N, int ldw, int noise_kind,
                          int quant_x,
                          int quant_w, int quant_out, int n_repeats, float inv_k) {
  Params p;
  p.x = x;
  p.w = w;
  p.rs = rs;
  p.cs = cs;
  p.wq = wq;
  p.sc = sc;
  p.seed = seed;
  p.out = out;
  p.B = B;
  p.M = M;
  p.K = K;
  p.N = N;
  p.ldw = ldw;
  p.cs_stride = cs_stride;
  p.noise_kind = noise_kind;
  p.quant_x = quant_x;
  p.quant_w = quant_w;
  p.quant_out = quant_out;
  p.n_repeats = n_repeats;
  p.inv_k = inv_k;
  return p;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                             uint32_t c1, uint32_t& o0, uint32_t& o1) {
  const uint32_t ks2 = k0 ^ k1 ^ PARITY;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#define TF_ROUND(d) \
  x0 += x1;         \
  x1 = rotl(x1, d); \
  x1 ^= x0;
#define TF_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_A
  x0 += k1; x1 += ks2 + 1u;
  TF_B
  x0 += ks2; x1 += k0 + 2u;
  TF_A
  x0 += k0; x1 += k1 + 3u;
  TF_B
  x0 += k1; x1 += ks2 + 4u;
  TF_A
  x0 += ks2; x1 += k0 + 5u;
#undef TF_A
#undef TF_B
#undef TF_ROUND
  o0 = x0;
  o1 = x1;
}

__device__ __forceinline__ float counter_gaussian(uint32_t k0, uint32_t k1, uint32_t c0,
                                                  uint32_t c1) {
  uint32_t b0, b1;
  threefry2x32(k0, k1, c0, c1, b0, b1);
  const float u1 = 1.0f - (float)(b0 >> 8) * UNIT;  // (0, 1]: log finite
  const float u2 = (float)(b1 >> 8) * UNIT;
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(TWO_PI, u2)));
}

__device__ __forceinline__ float repeat_gaussian(uint32_t k0, uint32_t k1, uint32_t c0,
                                                 uint32_t c1, int n_repeats, float inv_k) {
  float xi = counter_gaussian(k0, k1, c0, c1);
  for (int r = 1; r < n_repeats; ++r) {
    xi = __fadd_rn(xi, counter_gaussian(k0, k1 ^ ((uint32_t)r * REPEAT_STREAM_MULT), c0, c1));
  }
  if (n_repeats > 1) xi = __fmul_rn(xi, inv_k);
  return xi;
}

__device__ __forceinline__ float fake_quant(float v, float delta, float zp, float bins) {
  // rintf rounds half to even, as jnp.round does
  float code = __fadd_rn(rintf(__fdiv_rn(v, delta)), zp);
  code = fminf(fmaxf(code, 0.0f), bins);
  return __fmul_rn(__fsub_rn(code, zp), delta);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Output noise and requant of the accumulated y at flattened row r (request
// b = r / M, local noise row r - b * M) and column c: the same operations, in
// the same order, as the epilogue of the simt kernel.
__device__ __forceinline__ float finish_output(const Params& p, int r, int c, float y) {
  if (p.noise_kind == NOISE_OUTPUT) {
    const int b = r / p.M;
    const uint32_t li = (uint32_t)(r - b * p.M);
    const uint32_t* s = p.seed + 4 * b;
    const float xi = repeat_gaussian(s[0], s[1], s[2] + li, s[3] + (uint32_t)c, p.n_repeats,
                                     p.inv_k);
    y = __fadd_rn(y, __fmul_rn(__fmul_rn(p.rs[r], p.cs[(size_t)b * p.cs_stride + c]), xi));
  }
  if (p.quant_out) y = fake_quant(y, p.sc[3], p.sc[4], p.sc[5]);
  return y;
}

// The second pass of a split-K route (decode, weight): ws holds `splits`
// partial sums (splits, B * M, N). Warp l adds splits l, l + 8, l + 16, ...
// in order, then lane order 0..7 adds the warps' sums and thread (0, j)
// finishes output (row, col j): one fixed order, no float atomics.
// grid (N / 32, B * M), F_LANES * 32 threads.
constexpr int F_LANES = 8;
static __global__ void __launch_bounds__(F_LANES * 32)
    splits_finish_kernel(const Params p, int splits, const float* __restrict__ ws) {
  __shared__ float part[F_LANES][32];
  const int lane = threadIdx.x & 31, l = threadIdx.x >> 5;
  const int r = blockIdx.y, c = blockIdx.x * 32 + lane;
  const size_t n_out = (size_t)p.B * p.M * p.N;
  const size_t idx = (size_t)r * p.N + c;
  float s = 0.0f;
  if (c < p.N && l < splits) {
    s = ws[(size_t)l * n_out + idx];
#pragma unroll 4
    for (int sp = l + F_LANES; sp < splits; sp += F_LANES) s = __fadd_rn(s, ws[(size_t)sp * n_out + idx]);
  }
  part[l][lane] = s;
  __syncthreads();
  if (l != 0 || c >= p.N) return;
  float y = part[0][lane];
  for (int i = 1; i < min(F_LANES, splits); ++i) y = __fadd_rn(y, part[i][lane]);
  p.out[idx] = finish_output(p, r, c, y);
}

}  // namespace analog
