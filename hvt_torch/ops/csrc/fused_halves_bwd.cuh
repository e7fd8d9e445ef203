// Device code of the attention half's backward (fused_halves_bwd.cu on the
// NHWC map, attention_half.cu on pre-partitioned windows): the LayerNorm
// backward epilogue and the backward kernels, templated on the token layout
// (fused_halves.cuh), whose attention core runs on tensor cores
// (attention_fwd_tc.cuh, attention_bwd_tc.cuh); the weight gradients go
// through gemm_tc.cuh's `grad_tn`.
#pragma once

#include "attention_bwd_tc.cuh"
#include "attention_fwd_tc.cuh"
#include "fused_halves.cuh"
#include "gemm_tc.cuh"

namespace hvt {

// LayerNorm backward on a (32 x C) f32 tile of pre-LN sums without their
// bias, laid out as tile_row_sums (common.cuh) describes. Recomputes the
// LayerNorm statistics (ln_center), then with gs = grad(row, col) (the branch's upstream
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
// Attention half
// ---------------------------------------------------------------------------
//
// Four kernels, then dx and the weight gradients:
//  1. attn_half_bwd_ao_kernel: the attention output ao (bf16, T x C)
//     recomputed by the forward's device code (attn_half_ao,
//     fused_halves.cuh), one block of kTcThreads threads per (chunk of
//     windows, window id, head) on tensor cores, so it equals the
//     forward's bit for bit;
//  2. attn_half_bwd_proj_kernel: per 32 token rows, proj = ao·Wprojᵀ + b
//     and the LayerNorm backward on gs = bf16(s·g) to dproj (bf16), with
//     the column partials of dbproj, dlns and dlnb;
//  3. attn_half_bwd_core_kernel: per (chunk of windows, window id, head),
//     q|k|v and dao = dproj·Wproj[:, head] recomputed on tensor cores in one
//     stream over C, split into three pieces each, then
//     attention_window_bwd_tc<3> (attention_bwd_tc.cuh): dq, dk, dv to dqkv
//     (bf16) at the tokens' own rows, dz and dscale in registers across the
//     chunk's windows, the head's dbqkv columns summed in a fixed order;
//     one partial of each per block;
//  4. attn_half_bwd_dx_kernel: dx = g + dqkv·Wqkv per 32 token rows.
// Kernels 1 and 3 take C at run time (their tiles do not grow with it); 2 and
// 4 hold a (32 x C) tile and take it as a template parameter.

// Kernel 3: q, k, v, dao; stages of 64 token rows, 96 q|k|v weight rows, 64
// dproj rows and 32 Wproj rows; P's and dS's bf16 halves and the f32 dq,
// dk, dv tiles.
constexpr int kCoreStageRows = kTcRows + kTcQkvRows + kTcRows + kD;
using CoreSmem = TcHalfSmem<4, kCoreStageRows,
                            sizeof(bf16) * 2 * kTcRows * kTcRows +
                                sizeof(float) * 3 * kTcRows * kTcOutLd>;

// As slice_mma_nt with B (kKS x 8·NT) k-major: element (k, j) at B[k·kLDK + j].
template <int NT>
__device__ __forceinline__ void slice_mma_nn(float (&acc)[NT][4], const bf16* A, const bf16* B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < kKS / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, A + (16 * warp + a_row) * kLDK + 16 * ks + a_col);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, B + (16 * ks + a_row) * kLDK + 16 * np + a_col);
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Kernel 1: the forward's attention output (attn_half_ao, fused_halves.cuh),
// recomputed, under a name of its own.
template <typename Layout>
__global__ void __launch_bounds__(kTcThreads, 2)
attn_half_bwd_ao_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                        const float* __restrict__ bqkv, const float* __restrict__ scale,
                        const float* __restrict__ z, int nwz, bf16* __restrict__ ao, int nwin,
                        int per_block, Layout lay, int C, int heads) {
  attn_half_ao(x, wqkv, bqkv, scale, z, nwz, ao, nwin, per_block, lay, C, heads);
}

// Kernel 2, rows [blockIdx.x·rows_per_block, ...) of T in tiles of 32: proj =
// ao·Wprojᵀ (tensor cores), the LayerNorm backward on gs = bf16(s·g) (g where
// s is null; s indexed by the row's image, tpi rows an image) to dproj
// (bf16), and part[block] = the block's column sums [dbproj | dlns | dlnb].
template <int C>
__global__ void __launch_bounds__(kThreads)
attn_half_bwd_proj_kernel(const bf16* __restrict__ ao, const bf16* __restrict__ wproj,
                          const float* __restrict__ bproj, const float* __restrict__ lns,
                          const float* __restrict__ s, int tpi, const bf16* __restrict__ gout,
                          bf16* __restrict__ dproj, float* __restrict__ part, int T,
                          int rows_per_block) {
  constexpr int LDA = C + 8, NT = C / 32;
  extern __shared__ uint4 smem_u4[];
  bf16* As = reinterpret_cast<bf16*>(smem_u4);  // 32 rows of ao
  bf16* WB = As + 32 * LDA;                     // a kKS slice of Wproj's columns
  float* colacc = reinterpret_cast<float*>(WB + C * kLDK);  // 2 x 3 x C column sums
  float* red = colacc + 6 * C;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps over (32 x C)
  const int r_lo = wm * 16 + (lane >> 2), r_hi = r_lo + 8;
  for (int i = threadIdx.x; i < 6 * C; i += kThreads) colacc[i] = 0.f;
  const int row_end = min(T, (blockIdx.x + 1) * rows_per_block);
  for (int row0 = blockIdx.x * rows_per_block; row0 < row_end; row0 += 32) {
    const int rows = min(32, row_end - row0);
    __syncthreads();  // the previous tile is done with As
    copy_rows(As, LDA, 32, C, [&](int r) -> const bf16* {
      return r < rows ? ao + (size_t)(row0 + r) * C : nullptr;
    });
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kKS) {
      __syncthreads();
      copy_rows(WB, kLDK, C, kKS, [&](int r) { return wproj + (size_t)r * C + k0; });
      __syncthreads();
      warp_mma<NT, kKS>(acc, As + wm * 16 * LDA + k0, LDA, 16, WB + wn * (C / 4) * kLDK, kLDK);
    }
    float sc_lo = 1.f, sc_hi = 1.f;
    if (s != nullptr) {
      sc_lo = r_lo < rows ? s[(row0 + r_lo) / tpi] : 0.f;
      sc_hi = r_hi < rows ? s[(row0 + r_hi) / tpi] : 0.f;
    }
    auto grad = [&](int r, int col) -> float2 {
      if (r >= rows) return make_float2(0.f, 0.f);
      const bf16* gr = gout + (size_t)(row0 + r) * C + col;
      if (s == nullptr) return make_float2(to_f32(gr[0]), to_f32(gr[1]));
      const float sc = r == r_lo ? sc_lo : sc_hi;
      return make_float2(round_bf16(sc * to_f32(gr[0])), round_bf16(sc * to_f32(gr[1])));
    };
    ln_bwd_epilogue<NT>(acc, bproj, lns, red, colacc, grad, [&](int r, int col, float d0, float d1) {
      if (r < rows)
        *reinterpret_cast<uint32_t*>(dproj + (size_t)(row0 + r) * C + col) = pack_bf16x2(d0, d1);
    });
  }
  __syncthreads();
  float* bpart = part + (size_t)blockIdx.x * 3 * C;
  for (int i = threadIdx.x; i < 3 * C; i += kThreads) bpart[i] = colacc[i] + colacc[3 * C + i];
}

template <int C>
constexpr size_t proj_smem_bytes() {
  return sizeof(bf16) * (32 * (C + 8) + C * kLDK) + sizeof(float) * (6 * C + 128);
}

// Kernel 3, blocks as kernel 1's. Per window: q|k|v of head h and dao =
// dproj·Wproj[:, h·32..] in one stream over C, the core's backward, dq, dk,
// dv to dqkv (bf16, T x 3C) at the tokens' own rows. The chunk's dz and
// dscale stay in registers and the head's dbqkv columns in threads 0-95
// (each summing its column's rows in order); the block writes one partial of
// each: dz_part and ds_part at ((chunk·nwz + wz)·heads + h), db_part's 96
// columns of the head at (chunk·nwz + wz).
template <typename Layout>
__global__ void __launch_bounds__(kTcThreads, 2)
attn_half_bwd_core_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                          const float* __restrict__ bqkv, const float* __restrict__ scale,
                          const float* __restrict__ z, int nwz, const bf16* __restrict__ wproj,
                          const bf16* __restrict__ dproj, bf16* __restrict__ dqkv,
                          float* __restrict__ dz_part, float* __restrict__ ds_part,
                          float* __restrict__ db_part, int nwin, int per_block, Layout lay,
                          int C, int heads) {
  constexpr int kStage = kCoreStageRows * kLDK;
  constexpr int kDRow = kTcRows + kTcQkvRows, kPRow = kDRow + kTcRows;  // dproj, Wproj rows
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* const tiles = reinterpret_cast<bf16*>(tc_smem);
  float* const zs = reinterpret_cast<float*>(tc_smem + CoreSmem::zs);
  float* const inv = reinterpret_cast<float*>(tc_smem + CoreSmem::inv);
  float* const red = inv + 2 * kTcRows;
  bf16* const stages = reinterpret_cast<bf16*>(tc_smem + CoreSmem::region);
  // during the attention: P's and dS's halves, then the f32 dq, dk, dv tiles
  bf16* const ps = stages;
  float* const dout = reinterpret_cast<float*>(ps + 2 * kTcRows * kTcRows);

  const int n = lay.n(), nw = lay.windows();
  const int wz = blockIdx.x % nwz, chunk = blockIdx.x / nwz, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid >> 2, ch = tid & 3;
  const float sc = scale[h];
  tc_load_z(zs, z + ((size_t)wz * heads + h) * n * n, n);
  float dz[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dz[nt][e] = 0.f;
  float dscale = 0.f, dbias = 0.f;  // thread tid < 96 owns dbqkv column tid of the head

  const int u_end = min((chunk + 1) * per_block, nwin / nwz);
  for (int u = chunk * per_block; u < u_end; ++u) {
    const int w = u * nwz + wz;
    long long tok[2];
    token_offsets(tok, lay.at(w / nw, w % nw), n, C);
    float acc[12][4], dacc[4][4];
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dacc[j][0] = dacc[j][1] = dacc[j][2] = dacc[j][3] = 0.f;
    stream_slices(
        C,
        [&](int k0, int s) {
          bf16* st = stages + s * kStage;
          load_tokens(st, 0, x, tok, k0);
          load_wqkv(st, wqkv, C, h, k0);
          load_tokens(st, kDRow, dproj, tok, k0);
          cp_async16(st + (kPRow + r) * kLDK + 8 * ch, wproj + (size_t)(k0 + r) * C + h * kD + 8 * ch);
          cp_async_commit();
        },
        [&](int s) {
          const bf16* st = stages + s * kStage;
          slice_mma_nt<12>(acc, st, st + kTcRows * kLDK);
          slice_mma_nn<4>(dacc, st + kDRow * kLDK, st + kPRow * kLDK);
        });
    put_qkv(tiles, 4, acc, bqkv, C, h, n);
    {
      const int r0 = 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        put_pieces(tiles, 4, 3, r0, 8 * j + 2 * t, dacc[j][0], dacc[j][1], n);
        put_pieces(tiles, 4, 3, r0 + 8, 8 * j + 2 * t, dacc[j][2], dacc[j][3], n);
      }
    }
    __syncthreads();
    attention_window_bwd_tc<3>(tiles, ps, inv, n, sc, zs, dz, dscale,
                               [&](int op, int row, int col, float v0, float v1) {
                                 *reinterpret_cast<float2*>(dout + (op * kTcRows + row) * kTcOutLd +
                                                            col) = make_float2(v0, v1);
                               });
    __syncthreads();
#pragma unroll
    for (int op = 0; op < 3; ++op)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (tok[i] < 0) continue;
        const float* o = dout + (op * kTcRows + r + 32 * i) * kTcOutLd + 8 * ch;
        const float4 a = *reinterpret_cast<const float4*>(o), b = *reinterpret_cast<const float4*>(o + 4);
        *reinterpret_cast<uint4*>(dqkv + 3 * tok[i] + (size_t)op * C + h * kD + 8 * ch) =
            make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                       pack_bf16x2(b.z, b.w));
      }
    if (tid < 3 * kD) {
      const float* o = dout + (tid / kD) * kTcRows * kTcOutLd + tid % kD;
      float cs = 0.f;
      for (int i = 0; i < n; ++i) cs += o[i * kTcOutLd];
      dbias += cs;
    }
    __syncthreads();  // dout shares the stages' space, and the tiles are rewritten next
  }

  const size_t part = ((size_t)chunk * nwz + wz) * heads + h;
  float* zp = dz_part + part * n * n;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e >> 1) * 8, col = 8 * nt + c0 + (e & 1);
      if (row < n && col < n) zp[row * n + col] = dz[nt][e];
    }
  if (tid < 3 * kD)
    db_part[((size_t)chunk * nwz + wz) * 3 * C + (tid / kD) * C + h * kD + tid % kD] = dbias;
  dscale = warp_sum(dscale);
  if (lane == 0) red[warp] = dscale;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < kTcThreads / 32; ++i) sum += red[i];
    ds_part[part] = sum;
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
                    float* ds_part, float* wpart, int per_block, int chunks, int proj_rows,
                    int splits_qkv, int splits_proj, int B, Layout lay, int heads,
                    cudaStream_t st) {
  const int n = lay.n(), nw = lay.windows(), nwin = B * nw, T = nwin * n;
  if (n < 1 || n > kTcRows || proj_rows % 32) return -1;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const bf16* wp = static_cast<const bf16*>(wproj);
  const bf16* gb = static_cast<const bf16*>(g);
  bf16* aob = static_cast<bf16*>(ao);
  bf16* dpb = static_cast<bf16*>(dproj);
  bf16* dqb = static_cast<bf16*>(dqkv);
  const dim3 heads_grid(chunks * nwz, heads);
  int err;

  auto aok = attn_half_bwd_ao_kernel<Layout>;
  if ((err = allow_smem(aok, AoSmem::bytes))) return err;
  aok<<<heads_grid, kTcThreads, AoSmem::bytes, st>>>(xb, wq, bqkv, scale, z, nwz, aob, nwin,
                                                     per_block, lay, C, heads);
  if ((err = (int)cudaGetLastError())) return err;

  auto proj = attn_half_bwd_proj_kernel<C>;
  const int proj_blocks = (T + proj_rows - 1) / proj_rows;
  if ((err = allow_smem(proj, proj_smem_bytes<C>()))) return err;
  proj<<<proj_blocks, kThreads, proj_smem_bytes<C>(), st>>>(aob, wp, bproj, lns, s, nw * n, gb,
                                                            dpb, part_a, T, proj_rows);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_parts(part_a, proj_blocks, 3LL * C, dsmall + 3 * C, st))) return err;

  auto core = attn_half_bwd_core_kernel<Layout>;
  if ((err = allow_smem(core, CoreSmem::bytes))) return err;
  core<<<heads_grid, kTcThreads, CoreSmem::bytes, st>>>(xb, wq, bqkv, scale, z, nwz, wp, dpb, dqb,
                                                        dz_part, ds_part, part_b, nwin, per_block,
                                                        lay, C, heads);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = sum_parts(dz_part, chunks, (long long)nwz * heads * n * n, dz, st))) return err;
  if ((err = sum_parts(ds_part, chunks * nwz, heads, dscale, st))) return err;
  if ((err = sum_parts(part_b, chunks * nwz, 3LL * C, dsmall, st))) return err;

  auto dxk = attn_half_bwd_dx_kernel<C>;
  const size_t smem_c = sizeof(bf16) * (32 * kLDK + kKS * (C + 8));
  if ((err = allow_smem(dxk, smem_c))) return err;
  dxk<<<(T + 31) / 32, kThreads, smem_c, st>>>(dqb, wq, gb, s != nullptr, static_cast<bf16*>(dx),
                                                T);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = grad_tn(dqb, xb, dwqkv, wpart, splits_qkv, T, 3 * C, C, false, st))) return err;
  return grad_tn(dpb, aob, dwproj, wpart, splits_proj, T, C, C, false, st);
}

}  // namespace hvt
