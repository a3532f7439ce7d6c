// Route "decode" of the analog matmul for Hopper (sm_90a): few rows per
// request, bf16 x and w, output or no noise, any quantizer flags. Plain C
// entry point for ctypes.
//
// Replaces, for these calls, the Pallas TPU kernel `_kernel` of
// src/repro/kernels/analog_matmul.py (pallas_call at line 208). It computes
// the same function as the simt route (analog_matmul.cu): quant_x, quant_w,
// the f32 accumulate over K, output noise rs[i] * cs[j] * xi at global
// counters, quant_out.
//
// Bound on the H100: at R = B * M <= 16 rows the product does about 2R FLOPs
// per 2 bytes of weight, far below the ~295 FLOP/byte at which the bf16
// tensor cores would bound it, so every decode site is bound by the weight
// bytes over 3.35 TB/s (gate/up: 105 MB, 31 us). The design streams the
// weights once at HBM rate and does the products on the f32 SIMT units:
//   * each thread reads 8 neighbouring bf16 columns of w (K, N) with one
//     16-byte load, a warp 512 contiguous bytes of one weight row; D_U loads
//     are issued before any is used, so ~64 KB a SM are in flight. With 8
//     or 16 rows a block, 8 columns would need 64-128 accumulators a thread
//     and leave one block a SM, so a thread then takes 4 columns (8-byte
//     loads, a warp 256 contiguous bytes);
//   * the K dimension is spread over the 8 warps of a block (k lanes) and
//     over blocks (split-K, `splits` slices of `kc` rows), so one wave of
//     about 4 blocks a SM covers the card at every site shape; the plan
//     depends on (K, N) only (analog_matmul.py decode_plan), N being the
//     whole weight's for a column shard, which so sums as the whole does;
//   * the block stages its x slice (RT rows x kc) in shared memory as f32,
//     quant_x applied on load; quant_w is applied to each loaded weight;
//   * the k lanes of a block are added in shared memory in lane order, the
//     block writes one partial per (split, row, col) to a workspace, and a
//     second kernel (analog_common.cuh splits_finish_kernel) adds the splits
//     in a fixed order (8 lanes of every 8th split, then the lanes in order;
//     no float atomics), then adds the noise and requantizes exactly as the
//     simt epilogue does.
// So every output's sum is taken in an order fixed by (K, N) alone: a
// request's rows are the same bits alone or in any batch, and from launch
// to launch: which block holds a row or a column never changes its sum.
// Rows beyond RT (16) a block go to further blocks (grid.x), which re-read
// the weights; the route is chosen only up to M_DECODE rows a request.

#include <algorithm>

#include "analog_common.cuh"

namespace {

using namespace analog;

constexpr int D_THREADS = 256;
constexpr int D_TPC = 32;                    // threads across the columns of a k row
constexpr int D_KL = D_THREADS / D_TPC;      // 8 k lanes (one per warp)
constexpr int D_U = 4;                       // weight loads in flight a thread
constexpr int D_RC = 4;                      // rows added per round of the lane reduction

// CPT bf16 columns a thread, one load: 16 bytes (CPT = 8) or 8 bytes (4)
template <int CPT>
struct WLoad;
template <>
struct WLoad<8> {
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0, 0, 0, 0); }
};
template <>
struct WLoad<4> {
  using T = uint2;
  static __device__ __forceinline__ T zero() { return make_uint2(0, 0); }
};

template <int CPT, typename T>
__device__ __forceinline__ void unpack(const T v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < CPT / 2; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// grid (row groups, col tiles, splits); dynamic shared memory
// max(kc * RT * 4, D_KL * D_RC * CPT * D_TPC * 4). ws is (splits, B * M, N) f32.
// RT rows a block, CPT columns a thread (so RT * CPT accumulators).
template <int RT, int CPT, bool QW>
__global__ void __launch_bounds__(D_THREADS)
    decode_partial_kernel(const Params p, int kc, float* __restrict__ ws) {
  using L = WLoad<CPT>;
  using LT = typename L::T;
  constexpr int BN = CPT * D_TPC;  // columns a block
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kc][RT], transposed
  const __nv_bfloat16* __restrict__ x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* __restrict__ w = static_cast<const __nv_bfloat16*>(p.w);
  const int tid = threadIdx.x;
  const int tc = tid % D_TPC;
  const int tk = tid / D_TPC;
  const int rows = p.B * p.M;
  const int row_base = blockIdx.x * RT;
  const int col = blockIdx.y * BN + tc * CPT;
  const int split = blockIdx.z;
  const int k_begin = split * kc;
  const int klen = min(kc, p.K - k_begin);

  const float xd = p.sc[0], xz = p.sc[1], xbins = p.sc[2];
  for (int e = tid; e < RT * klen; e += D_THREADS) {
    const int r = e / klen, kk = e - r * klen;
    const int row = row_base + r;
    float v = 0.0f;
    if (row < rows) {
      v = to_f32(x[(size_t)row * p.K + k_begin + kk]);
      if (p.quant_x) v = fake_quant(v, xd, xz, xbins);
    }
    xs[kk * RT + r] = v;
  }

  const bool col_ok = col < p.N;  // N % 8 == 0: a thread's columns are all in or all out
  float qd[CPT], qz[CPT], qb[CPT];
  if (QW) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = col_ok ? col + c : 0;
      qd[c] = p.wq[j];
      qz[c] = p.wq[p.N + j];
      qb[c] = p.wq[2 * p.N + j];
    }
  }
  float acc[RT][CPT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;
  __syncthreads();

  const LT* wp = reinterpret_cast<const LT*>(w + (size_t)k_begin * p.ldw + (col_ok ? col : 0));
  const size_t row_stride = (size_t)p.ldw / CPT;  // in loads
  for (int k0 = tk; k0 < klen; k0 += D_KL * D_U) {
    LT v[D_U];
#pragma unroll
    for (int u = 0; u < D_U; ++u) {
      const int kk = k0 + u * D_KL;
      v[u] = (col_ok && kk < klen) ? __ldg(wp + (size_t)kk * row_stride) : L::zero();
    }
#pragma unroll
    for (int u = 0; u < D_U; ++u) {
      const int kk = k0 + u * D_KL;
      if (kk < klen) {
        float wf[CPT];
        unpack<CPT>(v[u], wf);
        if (QW) {
#pragma unroll
          for (int c = 0; c < CPT; ++c) wf[c] = fake_quant(wf[c], qd[c], qz[c], qb[c]);
        }
        float xv[RT];
        const float4* xr = reinterpret_cast<const float4*>(xs + kk * RT);
#pragma unroll
        for (int q = 0; q < RT / 4; ++q) {
          const float4 t = xr[q];
          xv[4 * q] = t.x;
          xv[4 * q + 1] = t.y;
          xv[4 * q + 2] = t.z;
          xv[4 * q + 3] = t.w;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(xv[r], wf[c], acc[r][c]);
      }
    }
  }

  // add the k lanes in lane order, D_RC rows a round, through shared memory
  float* red = reinterpret_cast<float*>(smem4);  // [D_KL][D_RC][BN]
  const int col_tile = blockIdx.y * BN;
#pragma unroll
  for (int r0 = 0; r0 < RT; r0 += D_RC) {
    __syncthreads();  // xs (first round) or the previous round is consumed
#pragma unroll
    for (int rr = 0; rr < D_RC; ++rr) {
      float4* dst = reinterpret_cast<float4*>(red + (tk * D_RC + rr) * BN + tc * CPT);
#pragma unroll
      for (int q = 0; q < CPT / 4; ++q)
        dst[q] = make_float4(acc[r0 + rr][4 * q], acc[r0 + rr][4 * q + 1],
                             acc[r0 + rr][4 * q + 2], acc[r0 + rr][4 * q + 3]);
    }
    __syncthreads();
    for (int e = tid; e < D_RC * BN; e += D_THREADS) {
      const int rr = e / BN, j = e - rr * BN;
      const int row = row_base + r0 + rr, c = col_tile + j;
      if (row >= rows || c >= p.N) continue;
      float s = red[rr * BN + j];
#pragma unroll
      for (int l = 1; l < D_KL; ++l) s = __fadd_rn(s, red[(l * D_RC + rr) * BN + j]);
      ws[((size_t)split * rows + row) * p.N + c] = s;
    }
  }
}

template <int RT, int CPT, bool QW>
cudaError_t launch_partial(const Params& p, int kc, int splits, int row_groups, int col_tiles,
                           float* ws, cudaStream_t s) {
  const int smem = std::max(kc * RT * 4, D_KL * D_RC * CPT * D_TPC * 4);
  auto kernel = decode_partial_kernel<RT, CPT, QW>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(row_groups, col_tiles, splits), D_THREADS, smem, s>>>(p, kc, ws);
  return cudaGetLastError();
}

template <int RT, int CPT>
cudaError_t launch_partial_q(const Params& p, int kc, int splits, int row_groups, int col_tiles,
                             float* ws, cudaStream_t s) {
  return p.quant_w ? launch_partial<RT, CPT, true>(p, kc, splits, row_groups, col_tiles, ws, s)
                   : launch_partial<RT, CPT, false>(p, kc, splits, row_groups, col_tiles, ws, s);
}

}  // namespace

// Launch on `stream`; returns the first CUDA error (0 on success). x and w
// bf16, K % 8 == 0, N % 8 == 0, w 16-byte aligned with rows ldw elements
// apart (ldw % 8 == 0: N, or the whole weight's N for a column shard, whose
// split of K the plan takes from the whole N). The plan (kc, splits,
// rt rows a block, row_groups, col_tiles) comes from decode_plan in
// analog_matmul.py; ws holds splits * B * M * N floats.
extern "C" int analog_decode_launch(const void* x, const void* w, const float* rs, const float* cs,
                                    int cs_stride, const float* wq, const float* sc,
                                    const uint32_t* seed, float* out, float* ws, int B, int M,
                                    int K, int N, int ldw, int noise_kind, int quant_x, int quant_w,
                                    int quant_out, int n_repeats, float inv_k, int kc, int splits,
                                    int rt, int row_groups, int col_tiles, void* stream) {
  const Params p = make_params(x, w, rs, cs, cs_stride, wq, sc, seed, out, B, M, K, N, ldw,
                               noise_kind, quant_x, quant_w, quant_out, n_repeats, inv_k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (rt) {
    case 4: e = launch_partial_q<4, 8>(p, kc, splits, row_groups, col_tiles, ws, s); break;
    case 8: e = launch_partial_q<8, 4>(p, kc, splits, row_groups, col_tiles, ws, s); break;
    case 16: e = launch_partial_q<16, 4>(p, kc, splits, row_groups, col_tiles, ws, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  splits_finish_kernel<<<dim3((N + 31) / 32, B * M), F_LANES * 32, 0, s>>>(p, splits, ws);
  return (int)cudaGetLastError();
}
