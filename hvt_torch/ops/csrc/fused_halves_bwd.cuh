// Device code shared by the fused halves' backwards (fused_halves_bwd.cu)
// and the chunked MLP half (fused_halves_chunked.cu): the LayerNorm backward
// epilogue, the weight-gradient product `grad_tn` and the shared-memory
// opt-in.
#pragma once

#include "fused_halves.cuh"

namespace hvt {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// LayerNorm backward on a (32 x C) f32 tile of pre-LN sums without their
// bias, held as in ln_epilogue. Recomputes the LayerNorm statistics
// (ln_center), then with gs = grad(row, col) (the branch's upstream
// gradient, a pair of neighbouring columns; zeros for a row outside the
// tile's valid rows):
//   dy = (gs·lns − mean(gs·lns) − normed·mean(gs·lns·normed))·inv   (_ln_bwd)
// hands each pair to store(row, col, dy0, dy1) and adds the column sums of
// dy, gs·normed and gs over the 32 rows to colacc[(wm·3 + q)·C + col], one
// lane owning each column of each warp-row half wm. red: 128 floats.
template <int NT, typename GradFn, typename StoreFn>
__device__ __forceinline__ void ln_bwd_epilogue(float (&acc)[NT][4], const float* __restrict__ bias,
                                                const float* __restrict__ lns, float* red,
                                                float* colacc, GradFn grad, StoreFn store) {
  constexpr int C = NT * 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = wm * 16 + g, r_hi = r_lo + 8;
  const int c0 = wn * (C / 4) + 2 * t;
  float inv_lo, inv_hi;
  ln_center<NT>(acc, bias, red, inv_lo, inv_hi);

  // acc -> normed; row means of gn = gs·lns and gn·normed
  float a_lo = 0.f, a_hi = 0.f, n_lo = 0.f, n_hi = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] *= inv_lo; acc[j][1] *= inv_lo; acc[j][2] *= inv_hi; acc[j][3] *= inv_hi;
    const int col = c0 + j * 8;
    const float s0 = lns[col], s1 = lns[col + 1];
    const float2 gl = grad(r_lo, col), gh = grad(r_hi, col);
    a_lo += gl.x * s0 + gl.y * s1;
    a_hi += gh.x * s0 + gh.y * s1;
    n_lo += gl.x * s0 * acc[j][0] + gl.y * s1 * acc[j][1];
    n_hi += gh.x * s0 * acc[j][2] + gh.y * s1 * acc[j][3];
  }
  float ma_lo, ma_hi, mn_lo, mn_hi;
  tile_row_sums(a_lo, a_hi, red, ma_lo, ma_hi);
  tile_row_sums(n_lo, n_hi, red, mn_lo, mn_hi);
  ma_lo /= C; ma_hi /= C; mn_lo /= C; mn_hi /= C;

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = c0 + j * 8;
    const float s0 = lns[col], s1 = lns[col + 1];
    const float2 gl = grad(r_lo, col), gh = grad(r_hi, col);
    const float d00 = (gl.x * s0 - ma_lo - acc[j][0] * mn_lo) * inv_lo;
    const float d01 = (gl.y * s1 - ma_lo - acc[j][1] * mn_lo) * inv_lo;
    const float d10 = (gh.x * s0 - ma_hi - acc[j][2] * mn_hi) * inv_hi;
    const float d11 = (gh.y * s1 - ma_hi - acc[j][3] * mn_hi) * inv_hi;
    store(r_lo, col, d00, d01);
    store(r_hi, col, d10, d11);
    float q[6] = {d00 + d10, d01 + d11, gl.x * acc[j][0] + gh.x * acc[j][2],
                  gl.y * acc[j][1] + gh.y * acc[j][3], gl.x + gh.x, gl.y + gh.y};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      q[k] += __shfl_xor_sync(0xffffffffu, q[k], 4);
      q[k] += __shfl_xor_sync(0xffffffffu, q[k], 8);
      q[k] += __shfl_xor_sync(0xffffffffu, q[k], 16);
    }
    if (g == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        colacc[(wm * 3 + k) * C + col] += q[2 * k];
        colacc[(wm * 3 + k) * C + col + 1] += q[2 * k + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Reductions and the weight-gradient product
// ---------------------------------------------------------------------------

constexpr int kGM = 64, kGN = 64, kGK = 32;  // tile of grad_tn_kernel: M x N, tokens per step

// out[z][m][n] = Σ_t A[t][m]·B[t][n] over the tokens of slice z
// (blockIdx.z); A (T, M) and B (T, N) bf16 row-major. Warps 2 (m) x 4 (n),
// each a 32 x 16 tile.
__global__ void __launch_bounds__(kThreads)
grad_tn_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ out,
               int T, int M, int N, int per_split) {
  __shared__ __align__(16) bf16 As[kGK * (kGM + 8)];
  __shared__ __align__(16) bf16 Bs[kGK * (kGN + 8)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kGM, n0 = blockIdx.x * kGN;
  const int t_begin = blockIdx.z * per_split;
  const int t_end = min(T, t_begin + per_split);
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += kGK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kGK * (kGM / 8); e += kThreads) {
      const int r = e / (kGM / 8), v = e - r * (kGM / 8);
      const int tok = t0 + r;
      uint4 a = make_uint4(0u, 0u, 0u, 0u), b = make_uint4(0u, 0u, 0u, 0u);
      if (tok < t_end && m0 + v * 8 < M)
        a = *reinterpret_cast<const uint4*>(A + (size_t)tok * M + m0 + v * 8);
      if (tok < t_end && n0 + v * 8 < N)
        b = *reinterpret_cast<const uint4*>(B + (size_t)tok * N + n0 + v * 8);
      *reinterpret_cast<uint4*>(As + r * (kGM + 8) + v * 8) = a;
      *reinterpret_cast<uint4*>(Bs + r * (kGN + 8) + v * 8) = b;
    }
    __syncthreads();
    warp_mma_tn<2, 2, kGK>(acc, As + wm * 32, kGM + 8, Bs + wn * 16, kGN + 8);
  }

  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + wm * 32 + i * 16 + g, n = n0 + wn * 16 + j * 8 + 2 * t;
      if (n >= N) continue;
      if (m < M) { o[(size_t)m * N + n] = acc[i][j][0]; o[(size_t)m * N + n + 1] = acc[i][j][1]; }
      if (m + 8 < M) {
        o[(size_t)(m + 8) * N + n] = acc[i][j][2];
        o[(size_t)(m + 8) * N + n + 1] = acc[i][j][3];
      }
    }
}

// out (M, N) = Aᵀ·B over T tokens in `splits` slices; slices beyond the
// first land in `part` (splits·M·N floats) and are summed in order.
inline int grad_tn(const bf16* A, const bf16* B, float* out, float* part, int splits, int T,
                   int M, int N, cudaStream_t st) {
  int per = (T + splits - 1) / splits;
  per = (per + kGK - 1) / kGK * kGK;
  splits = (T + per - 1) / per;
  const dim3 grid((N + kGN - 1) / kGN, (M + kGM - 1) / kGM, splits);
  grad_tn_kernel<<<grid, kThreads, 0, st>>>(A, B, splits == 1 ? out : part, T, M, N, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return sum_parts(part, splits, (long long)M * N, out, st);
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace hvt
