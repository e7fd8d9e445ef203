// Device code shared by the fused halves' backwards (fused_halves_bwd.cu,
// attention_half.cu) and the chunked MLP half (fused_halves_chunked.cu):
// the LayerNorm backward epilogue, the weight-gradient product `grad_tn`,
// the shared-memory opt-in, and the attention half's backward kernels,
// templated on the token layout (fused_halves.cuh).
#pragma once

#include "fused_halves.cuh"

namespace hvt {

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

// ---------------------------------------------------------------------------
// Attention half
// ---------------------------------------------------------------------------

// One block per (image, window): the forward to proj (as
// attn_half_fwd_kernel), the attention output to `ao`, and the LayerNorm
// backward on gs = bf16(s·g) (g where s is null) to `dproj` (both bf16, at
// the tokens' own rows); part[block] gets the column sums [dbproj | dlns |
// dlnb].
template <int C, typename Layout>
__global__ void __launch_bounds__(kThreads)
attn_half_bwd_proj_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                          const float* __restrict__ bqkv, const float* __restrict__ scale,
                          const float* __restrict__ z, int nwz, const bf16* __restrict__ wproj,
                          const float* __restrict__ bproj, const float* __restrict__ lns,
                          const float* __restrict__ s, const bf16* __restrict__ gout,
                          bf16* __restrict__ ao, bf16* __restrict__ dproj,
                          float* __restrict__ part, Layout lay, int heads) {
  constexpr int LDX = C + 8, NT = C / 32;
  const int n = lay.n(), nw = lay.windows();
  const AttnSmem L(n, C);
  extern __shared__ uint4 smem_u4[];
  char* smem = reinterpret_cast<char*>(smem_u4);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.x);
  bf16* WB = Xs;  // the proj pass reuses the token tile's space
  bf16* Os = reinterpret_cast<bf16*>(smem + L.o);
  float* QKV = reinterpret_cast<float*>(smem + L.qkv);
  float* colacc = reinterpret_cast<float*>(smem + L.colacc);  // after the heads
  float* S = reinterpret_cast<float*>(smem + L.s);
  bf16* WA = reinterpret_cast<bf16*>(smem + L.wa);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / nw, wid = blockIdx.x - b * nw;
  const auto win = lay.at(b, wid);
  copy_rows(Xs, LDX, n, C, [&](int i) { return x + win.token(i) * C; });
  const float* zw = z + (size_t)(nwz > 1 ? wid : 0) * heads * n * n;

  attn_heads_fwd<C>(Xs, Os, QKV, S, WA, n, heads, wqkv, bqkv, scale, zw);
  __syncthreads();
  for (int e = threadIdx.x; e < n * (C / 8); e += kThreads) {
    const int i = e / (C / 8), v = e - i * (C / 8);
    *reinterpret_cast<uint4*>(ao + win.token(i) * C + v * 8) =
        *reinterpret_cast<const uint4*>(Os + i * LDX + v * 8);
  }
  for (int i = threadIdx.x; i < 6 * C; i += kThreads) colacc[i] = 0.f;

  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps over (32 x C)
  const float sc = s != nullptr ? s[b] : 1.f;
  for (int r0 = 0; r0 < n; r0 += 32) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kKS) {
      __syncthreads();
      copy_rows(WB, kLDK, C, kKS, [&](int r) { return wproj + (size_t)r * C + k0; });
      __syncthreads();
      warp_mma<NT, kKS>(acc, Os + (r0 + wm * 16) * LDX + k0, LDX, n - r0 - wm * 16,
                        WB + wn * (C / 4) * kLDK, kLDK);
    }
    auto grad = [&](int r, int col) -> float2 {
      const int i = r0 + r;
      if (i >= n) return make_float2(0.f, 0.f);
      const bf16* gr = gout + win.token(i) * C + col;
      if (s == nullptr) return make_float2(to_f32(gr[0]), to_f32(gr[1]));
      return make_float2(round_bf16(sc * to_f32(gr[0])), round_bf16(sc * to_f32(gr[1])));
    };
    ln_bwd_epilogue<NT>(acc, bproj, lns, red, colacc, grad, [&](int r, int col, float d0, float d1) {
      const int i = r0 + r;
      if (i < n) *reinterpret_cast<uint32_t*>(dproj + win.token(i) * C + col) = pack_bf16x2(d0, d1);
    });
  }
  __syncthreads();
  float* bpart = part + (size_t)blockIdx.x * 3 * C;
  for (int i = threadIdx.x; i < 3 * C; i += kThreads) bpart[i] = colacc[i] + colacc[3 * C + i];
}

__host__ __device__ inline size_t core_smem_floats(int n) {
  constexpr int ld = kD + 1;
  return 5 * n * ld + 3 * n * (n + 1) + n * n + 2 * n + kThreads / 32;
}

__host__ __device__ inline size_t core_smem_bytes(int n) {
  return align16(sizeof(float) * core_smem_floats(n)) + sizeof(bf16) * (64 + 3 * kD) * kLDK;
}

// One block per (chunk of windows, window id, head), as window_attention_bwd.cu:
// for each window of the chunk, q|k|v of the head (x·Wqkv_h + b, tensor
// cores) and dao = dproj·Wproj[:, head] (tensor cores), then the f32 core
// backward of packed_heads_backward. dqkv goes out bf16 at the tokens' own
// rows (T, 3C); the chunk's dz sum stays in shared memory (each thread
// owns the same elements in every window), and dz, dscale and the head's
// dbqkv columns leave as one partial per block.
template <int C, typename Layout>
__global__ void __launch_bounds__(kThreads)
attn_half_bwd_core_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                          const float* __restrict__ bqkv, const float* __restrict__ scale,
                          const float* __restrict__ z, int nwz, const bf16* __restrict__ wproj,
                          const bf16* __restrict__ dproj, bf16* __restrict__ dqkv,
                          float* __restrict__ dz_part, float* __restrict__ ds_part,
                          float* __restrict__ db_part, int nwin, int per_block, Layout lay,
                          int heads) {
  constexpr int ld = kD + 1;
  const int n = lay.n(), ldS = n + 1, nw = lay.windows();
  extern __shared__ uint4 smem_u4[];
  float* Q = reinterpret_cast<float*>(smem_u4);  // q, then q̂
  float* K = Q + n * ld;                         // k, then k̂
  float* V = K + n * ld;                         // v, then dq̂ -> dq
  float* G = V + n * ld;                         // dao, then dk̂ -> dk
  float* DV = G + n * ld;                        // dv
  float* P = DV + n * ld;                        // logits, then softmax
  float* D = P + n * ldS;                        // dao·vᵀ, then dS
  float* Cs = D + n * ldS;                       // cos = q̂k̂ᵀ
  float* Z = Cs + n * ldS;                       // the chunk's dz sum
  float* invQ = Z + n * n;
  float* invK = invQ + n;
  float* red = invK + n;
  bf16* As = reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem_u4) +
                                     align16(sizeof(float) * core_smem_floats(n)));
  bf16* Ws = As + 64 * kLDK;

  const int wz = blockIdx.x % nwz, chunk = blockIdx.x / nwz, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps over 64 rows
  const float sc = scale[h];
  const float* zh = z + ((size_t)wz * heads + h) * n * n;
  for (int e = tid; e < n * n; e += kThreads) Z[e] = 0.f;
  float dscale = 0.f, dbias = 0.f;  // thread tid < 96 owns dbqkv column tid of the head

  const int u_end = min((chunk + 1) * per_block, nwin / nwz);
  for (int u = chunk * per_block; u < u_end; ++u) {
    const int w = u * nwz + wz;  // window id = w mod nwz
    const auto win = lay.at(w / nw, w % nw);

    // q|k|v of head h: (64 x 96), warp (wm, wn) -> rows 16·wm.., cols 48·wn..
    float acc[6][4];
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kKS) {
      __syncthreads();
      copy_rows(As, kLDK, 64, kKS, [&](int i) -> const bf16* {
        return i < n ? x + win.token(i) * C + k0 : nullptr;
      });
      copy_rows(Ws, kLDK, 3 * kD, kKS, [&](int r) {
        return wqkv + (size_t)((r / kD) * C + h * kD + r % kD) * C + k0;
      });
      __syncthreads();
      warp_mma<6, kKS>(acc, As + wm * 16 * kLDK, kLDK, 16, Ws + wn * 48 * kLDK, kLDK);
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int col = wn * 48 + j * 8 + 2 * t, part = col / kD, cc = col % kD;
      float* dst = part == 0 ? Q : (part == 1 ? K : V);
      const float bb0 = bqkv[part * C + h * kD + cc], bb1 = bqkv[part * C + h * kD + cc + 1];
      const int r_lo = wm * 16 + g, r_hi = r_lo + 8;
      if (r_lo < n) {
        dst[r_lo * ld + cc] = acc[j][0] + bb0;
        dst[r_lo * ld + cc + 1] = acc[j][1] + bb1;
      }
      if (r_hi < n) {
        dst[r_hi * ld + cc] = acc[j][2] + bb0;
        dst[r_hi * ld + cc + 1] = acc[j][3] + bb1;
      }
    }

    // dao of head h = dproj (64 x C) · Wproj[:, h·32..] : (64 x 32), warp -> cols 16·wn..
    float dacc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) dacc[j][0] = dacc[j][1] = dacc[j][2] = dacc[j][3] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kKS) {
      __syncthreads();
      copy_rows(As, kLDK, 64, kKS, [&](int i) -> const bf16* {
        return i < n ? dproj + win.token(i) * C + k0 : nullptr;
      });
      copy_rows(Ws, kLDK, kKS, kD, [&](int r) { return wproj + (size_t)(k0 + r) * C + h * kD; });
      __syncthreads();
      warp_mma_kn<2, kKS>(dacc, As + wm * 16 * kLDK, kLDK, 16, Ws + wn * 16, kLDK);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = wn * 16 + j * 8 + 2 * t;
      const int r_lo = wm * 16 + g, r_hi = r_lo + 8;
      if (r_lo < n) { G[r_lo * ld + col] = dacc[j][0]; G[r_lo * ld + col + 1] = dacc[j][1]; }
      if (r_hi < n) { G[r_hi * ld + col] = dacc[j][2]; G[r_hi * ld + col + 1] = dacc[j][3]; }
    }
    __syncthreads();

    attention_core_bwd(
        Q, K, V, G, P, D, Cs, Z, invQ, invK, n, kD, ld, sc, zh, dscale,
        [&](int j, int cc, float v) { DV[j * ld + cc] = v; },
        [&](bool isq, int i, int cc, float v) { (isq ? V : G)[i * ld + cc] = v; });
    __syncthreads();
    // dq (V), dk (G), dv (DV) -> dqkv bf16; the head's bias-gradient columns
    for (int e = tid; e < n * 3 * kD; e += kThreads) {
      const int i = e / (3 * kD), col = e - i * 3 * kD, part = col / kD, cc = col % kD;
      const float* src = part == 0 ? V : (part == 1 ? G : DV);
      dqkv[win.token(i) * 3 * C + part * C + h * kD + cc] = __float2bfloat16(src[i * ld + cc]);
    }
    if (tid < 3 * kD) {
      const float* src = (tid < kD ? V : (tid < 2 * kD ? G : DV)) + tid % kD;
      float cs = 0.f;
      for (int i = 0; i < n; ++i) cs += src[i * ld];
      dbias += cs;
    }
  }

  const size_t pidx = ((size_t)chunk * nwz + wz) * heads + h;
  for (int e = tid; e < n * n; e += kThreads) dz_part[pidx * n * n + e] = Z[e];
  if (tid < 3 * kD)
    db_part[((size_t)chunk * nwz + wz) * 3 * C + (tid / kD) * C + h * kD + tid % kD] = dbias;
  dscale = warp_sum(dscale);
  __syncthreads();
  if (lane == 0) red[warp] = dscale;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < nwarps; ++i) sum += red[i];
    ds_part[pidx] = sum;
  }
}

// dx = g + dqkv·Wqkv per token row (g left out without the fused residual),
// 32 rows a block, warps 2 x 4 as the MLP half; Wqkv streamed in slices of
// 32 of its 3C rows.
template <int C>
__global__ void __launch_bounds__(kThreads)
attn_half_bwd_dx_kernel(const bf16* __restrict__ dqkv, const bf16* __restrict__ wqkv,
                        const bf16* __restrict__ gout, int resid, bf16* __restrict__ dx, int T) {
  constexpr int NT = C / 32, LDB = C + 8;
  extern __shared__ uint4 smem_u4[];
  bf16* As = reinterpret_cast<bf16*>(smem_u4);
  bf16* Bs = As + 32 * kLDK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * 32;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int j0 = 0; j0 < 3 * C; j0 += kKS) {
    __syncthreads();
    copy_rows(As, kLDK, 32, kKS, [&](int r) -> const bf16* {
      return row0 + r < T ? dqkv + (size_t)(row0 + r) * 3 * C + j0 : nullptr;
    });
    copy_rows(Bs, LDB, kKS, C, [&](int r) { return wqkv + (size_t)(j0 + r) * C; });
    __syncthreads();
    warp_mma_kn<NT, kKS>(acc, As + wm * 16 * kLDK, kLDK, 16, Bs + wn * (C / 4), LDB);
  }
  const int c0 = wn * (C / 4) + 2 * t;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm * 16 + g + 8 * half;
      if (row >= T) continue;
      const size_t off = (size_t)row * C + c0 + j * 8;
      float y0 = acc[j][2 * half], y1 = acc[j][2 * half + 1];
      if (resid) {
        y0 += to_f32(gout[off]);
        y1 += to_f32(gout[off + 1]);
      }
      *reinterpret_cast<uint32_t*>(dx + off) = pack_bf16x2(y0, y1);
    }
  }
}

template <int C, typename Layout>
int launch_attn_bwd(const void* x, const void* wqkv, const float* bqkv, const float* scale,
                    const float* z, int nwz, const void* wproj, const float* bproj,
                    const float* lns, const float* s, const void* g, void* dx, float* dwqkv,
                    float* dwproj, float* dsmall, float* dscale, float* dz, void* ao,
                    void* dproj, void* dqkv, float* part_a, float* part_b, float* dz_part,
                    float* ds_part, float* wpart, int per_block, int chunks, int splits_qkv,
                    int splits_proj, int B, Layout lay, int heads, cudaStream_t st) {
  const int n = lay.n(), nw = lay.windows(), T = B * nw * n;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const bf16* wp = static_cast<const bf16*>(wproj);
  const bf16* gb = static_cast<const bf16*>(g);
  int err;

  auto proj = attn_half_bwd_proj_kernel<C, Layout>;
  const size_t smem_a = AttnSmem(n, C).bytes;
  if ((err = allow_smem(proj, smem_a))) return err;
  proj<<<B * nw, kThreads, smem_a, st>>>(xb, wq, bqkv, scale, z, nwz, wp, bproj, lns, s, gb,
                                        static_cast<bf16*>(ao), static_cast<bf16*>(dproj), part_a,
                                        lay, heads);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_parts(part_a, B * nw, 3LL * C, dsmall + 3 * C, st))) return err;

  auto core = attn_half_bwd_core_kernel<C, Layout>;
  const size_t smem_b = core_smem_bytes(n);
  if ((err = allow_smem(core, smem_b))) return err;
  core<<<dim3(chunks * nwz, heads), kThreads, smem_b, st>>>(
      xb, wq, bqkv, scale, z, nwz, wp, static_cast<const bf16*>(dproj), static_cast<bf16*>(dqkv),
      dz_part, ds_part, part_b, B * nw, per_block, lay, heads);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_parts(dz_part, chunks, (long long)nwz * heads * n * n, dz, st))) return err;
  if ((err = sum_parts(ds_part, chunks * nwz, heads, dscale, st))) return err;
  if ((err = sum_parts(part_b, chunks * nwz, 3LL * C, dsmall, st))) return err;

  auto dxk = attn_half_bwd_dx_kernel<C>;
  const size_t smem_c = sizeof(bf16) * (32 * kLDK + kKS * (C + 8));
  if ((err = allow_smem(dxk, smem_c))) return err;
  dxk<<<(T + 31) / 32, kThreads, smem_c, st>>>(static_cast<const bf16*>(dqkv), wq, gb,
                                                s != nullptr, static_cast<bf16*>(dx), T);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = grad_tn(static_cast<const bf16*>(dqkv), xb, dwqkv, wpart, splits_qkv, T, 3 * C, C,
                     st)))
    return err;
  return grad_tn(static_cast<const bf16*>(dproj), static_cast<const bf16*>(ao), dwproj, wpart,
                 splits_proj, T, C, C, st);
}

}  // namespace hvt
