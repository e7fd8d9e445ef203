// Device code shared by the fused SwinV2 block halves' forward
// (fused_halves.cu, attention_half.cu) and backward (fused_halves_bwd.cu):
// the attention half's token layouts, its attention output on tensor cores
// (which the backward recomputes) and its three forward kernels.
#pragma once

#include "attention_fwd_tc.cuh"
#include "gemm_tc.cuh"

namespace hvt {

constexpr int kThreads = 256;  // 8 warps
constexpr int kKS = 32;        // k-slice of streamed weight tiles
constexpr int kLDK = kKS + 8;  // padded row stride of a k-slice tile (bank-conflict free)
constexpr int kD = 32;         // head dim (every SwinV2 variant)

// ---------------------------------------------------------------------------
// Attention half: tensor-core pieces of the attention output, per (chunk of
// windows, window id, head), which the forward and the backward share
// ---------------------------------------------------------------------------

// Streamed operands arrive in slices of kKS columns of the reduction dim at
// row stride kLDK bf16 (80 bytes): the eight rows an ldmatrix reads fall in
// distinct banks.
constexpr int kTcQkvRows = 3 * kD;  // the head's q|k|v weight rows
// f32 row stride of the output staging tiles: 40 floats keep a half-warp's
// 8-byte fragment stores (rows g, columns 2t) in distinct banks.
constexpr int kTcOutLd = 40;

// Shared memory of the attention-output and backward-core kernels, bytes:
// the operand tiles (three pieces of each of kOps operands), z, the inverse
// norms and four floats of row sums, then one region that holds the two stages of streamed slices
// (kStageRows rows each) during the projections and, during the attention,
// kScratch bytes of the helper's and the outputs' tiles.
template <int kOps, int kStageRows, size_t kScratch>
struct TcHalfSmem {
  static constexpr size_t zs = sizeof(bf16) * 3 * kOps * kTcTile;  // the tiles come first
  static constexpr size_t inv = zs + sizeof(float) * kTcRows * kTcZLd;
  static constexpr size_t region = inv + sizeof(float) * (2 * kTcRows + kTcThreads / 32);
  static constexpr size_t stages = sizeof(bf16) * 2 * kStageRows * kLDK;
  static constexpr size_t bytes = region + (kScratch > stages ? kScratch : stages);
};
// The attention output: q, k, v; stages of 64 token rows and 96 weight rows;
// the f32 output tile.
using AoSmem = TcHalfSmem<3, kTcRows + kTcQkvRows, sizeof(float) * kTcRows * kTcOutLd>;

// Runs compute(stage) on each of the C / kKS slices of the reduction dim, slice
// s loaded by load(k0, stage) (cp.async, one group) into stage s & 1 while
// slice s − 1 is computed. Both stages must be free on entry; ends in a barrier.
template <typename LoadFn, typename ComputeFn>
__device__ __forceinline__ void stream_slices(int C, LoadFn load, ComputeFn compute) {
  const int steps = C / kKS;
  load(0, 0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load((s + 1) * kKS, (s + 1) & 1);
    else cp_async_commit();
    cp_async_wait<1>();  // slice s has landed
    __syncthreads();
    compute(s & 1);
    __syncthreads();  // stage s & 1 is free for slice s + 2
  }
}

// acc[j] += A·Bᵀ over one slice for the warp's 16 rows (16·warp..) of A and
// rows 8j.. of B: A (kTcRows x kKS) and B (8·NT x kKS) bf16 at row stride
// kLDK, the reduction dim contiguous in both.
template <int NT>
__device__ __forceinline__ void slice_mma_nt(float (&acc)[NT][4], const bf16* A, const bf16* B) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < kKS / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, A + (16 * warp + a_row) * kLDK + 16 * ks + a_col);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, B + (16 * np + b_row) * kLDK + 16 * ks + b_col);
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The pair (v0, v1) at (row, col) of operand `op` (of `ops` a piece) as three
// bf16 pieces into the swizzled tiles; zeros at row >= n.
__device__ __forceinline__ void put_pieces(bf16* tiles, int ops, int op, int row, int col,
                                           float v0, float v1, int n) {
  uint32_t p[3] = {0u, 0u, 0u};
  if (row < n) split3_bf16x2(v0, v1, p);
#pragma unroll
  for (int part = 0; part < 3; ++part)
    *reinterpret_cast<uint32_t*>(tiles + (part * ops + op) * kTcTile + swz32(row, col)) = p[part];
}

// The q|k|v projection's fragments (acc[j]: columns 8j.. of the head's 96,
// rows 16·warp + lane/4 (+8)) plus the bias, into the tiles of operands 0-2.
__device__ __forceinline__ void put_qkv(bf16* tiles, int ops, const float (&acc)[12][4],
                                        const float* __restrict__ bqkv, int C, int h, int n) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int op = j >> 2, col = 8 * (j & 3) + 2 * t;
    const float b0 = bqkv[op * C + h * kD + col], b1 = bqkv[op * C + h * kD + col + 1];
    put_pieces(tiles, ops, op, r0, col, acc[j][0] + b0, acc[j][1] + b1, n);
    put_pieces(tiles, ops, op, r0 + 8, col, acc[j][2] + b0, acc[j][3] + b1, n);
  }
}

// Thread tid streams 16-byte piece tid & 3 of rows tid/4 + 32·i of each
// slice, and reads and writes the same pieces of the window's token rows.
// tok[i]: the element offset of token row tid/4 + 32·i in a (rows, C) view,
// or -1 at or beyond n.
template <typename Window>
__device__ __forceinline__ void token_offsets(long long (&tok)[2], const Window& win, int n,
                                              int C) {
  const int r = threadIdx.x >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) tok[i] = r + 32 * i < n ? (long long)win.token(r + 32 * i) * C : -1;
}

// The head's q|k|v weight rows (Wqkv rows part·C + h·32 + r) of slice k0 into
// the stage's rows 64.., one cp.async a 16-byte piece.
__device__ __forceinline__ void load_wqkv(bf16* stage, const bf16* __restrict__ wqkv, int C,
                                          int h, int k0) {
  const int r = threadIdx.x >> 2, ch = threadIdx.x & 3;
#pragma unroll
  for (int part = 0; part < 3; ++part)
    cp_async16(stage + (kTcRows + part * kD + r) * kLDK + 8 * ch,
               wqkv + ((size_t)part * C + h * kD + r) * C + k0 + 8 * ch);
}

// Slice k0 of the window's token rows of `src` (rows < n) into the stage's
// rows `row0`.., one cp.async a 16-byte piece.
__device__ __forceinline__ void load_tokens(bf16* stage, int row0, const bf16* __restrict__ src,
                                            const long long (&tok)[2], int k0) {
  const int r = threadIdx.x >> 2, ch = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (tok[i] >= 0) cp_async16(stage + (row0 + r + 32 * i) * kLDK + 8 * ch, src + tok[i] + k0 + 8 * ch);
}

// ---------------------------------------------------------------------------
// Token layouts of the attention half
// ---------------------------------------------------------------------------
//
// The attention half's kernels take the windows of B images, nw = windows()
// an image, one block (or one loop step) per (image b, window wid), and find
// token i of a window at row at(b, wid).token(i) of a (rows, C) view of x
// and of every per-token buffer. The window id that indexes z is wid. Only
// the layout tells hvt's two entries apart: the TPU kernels share one body
// (`_attn_half_fwd_body`, `_attn_half_bwd_body`) and differ in the
// BlockSpecs that gather a window's tokens.

// The NHWC map (B, H, W, C) itself, the cyclic shift folded in: token i of
// window (wy, wx) sits at ((wy·ws + i/ws + shift) mod H, (wx·ws + i%ws +
// shift) mod W). hvt's `_attn_forward_nhwc` and `_attn_backward_nhwc`.
struct NhwcWindows {
  int H, W, ws, shift;
  struct Window {
    int b, wy, wx, H, W, ws, shift;
    __device__ size_t token(int i) const {
      const int r = i / ws, cc = i - r * ws;
      const int yy = (wy * ws + r + shift) % H, xx = (wx * ws + cc + shift) % W;
      return ((size_t)b * H + yy) * W + xx;
    }
  };
  __host__ __device__ int n() const { return ws * ws; }
  __host__ __device__ int windows() const { return (H / ws) * (W / ws); }
  __device__ Window at(int b, int wid) const {
    return {b, wid / (W / ws), wid % (W / ws), H, W, ws, shift};
  }
};

// Windows already partitioned, (nWB, N, C) with batch-major rows: window
// w = b·nw + wid, token i at row w·N + i. hvt's `_attn_forward` and
// `_attn_backward` on their (nb, nwz, n, c) view, with nw = nWZ.
struct FlatWindows {
  int nw, tokens;
  struct Window {
    size_t base;
    __device__ size_t token(int i) const { return base + i; }
  };
  __host__ __device__ int n() const { return tokens; }
  __host__ __device__ int windows() const { return nw; }
  __device__ Window at(int b, int wid) const { return {((size_t)b * nw + wid) * tokens}; }
};

// The attention output ao (bf16, rows as x's) of one block of kTcThreads
// threads, blockIdx (chunk·nwz + wz, h): head h's columns at the tokens of
// windows w = u·nwz + wz, u in [chunk·per_block, min((chunk + 1)·per_block,
// nwin / nwz)) (window id w mod nwz). Per window: q|k|v = x·W_h + b_h on
// tensor cores (mma.sync, C streamed in kKS slices by two-stage cp.async,
// f32 accumulation), split into three bf16 pieces, then
// attention_window_fwd_tc with P kept f32; the head's output is rounded to
// bf16 at the store (hvt's _dot rounds it before proj). Shared memory:
// AoSmem, which does not depend on C.
template <typename Layout>
__device__ __forceinline__ void attn_half_ao(const bf16* __restrict__ x,
                                             const bf16* __restrict__ wqkv,
                                             const float* __restrict__ bqkv,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ z, int nwz,
                                             bf16* __restrict__ ao, int nwin, int per_block,
                                             Layout lay, int C, int heads) {
  constexpr int kStage = (kTcRows + kTcQkvRows) * kLDK;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* const tiles = reinterpret_cast<bf16*>(tc_smem);
  float* const zs = reinterpret_cast<float*>(tc_smem + AoSmem::zs);
  float* const inv = reinterpret_cast<float*>(tc_smem + AoSmem::inv);
  bf16* const stages = reinterpret_cast<bf16*>(tc_smem + AoSmem::region);
  float* const out = reinterpret_cast<float*>(tc_smem + AoSmem::region);  // after the projection

  const int n = lay.n(), nw = lay.windows();
  const int wz = blockIdx.x % nwz, chunk = blockIdx.x / nwz, h = blockIdx.y;
  const int r = threadIdx.x >> 2, ch = threadIdx.x & 3;
  const float sc = scale[h];
  tc_load_z(zs, z + ((size_t)wz * heads + h) * n * n, n);  // the same for every window of the chunk

  const int u_end = min((chunk + 1) * per_block, nwin / nwz);
  for (int u = chunk * per_block; u < u_end; ++u) {
    const int w = u * nwz + wz;
    long long tok[2];
    token_offsets(tok, lay.at(w / nw, w % nw), n, C);
    float acc[12][4];
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    stream_slices(
        C,
        [&](int k0, int s) {
          load_tokens(stages + s * kStage, 0, x, tok, k0);
          load_wqkv(stages + s * kStage, wqkv, C, h, k0);
          cp_async_commit();
        },
        [&](int s) { slice_mma_nt<12>(acc, stages + s * kStage, stages + s * kStage + kTcRows * kLDK); });
    put_qkv(tiles, 3, acc, bqkv, C, h, n);
    __syncthreads();
    attention_window_fwd_tc<float, false>(tiles, inv, n, sc, zs,
                                          [&](int row) { return out + row * kTcOutLd; });
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (tok[i] < 0) continue;
      const float* o = out + (r + 32 * i) * kTcOutLd + 8 * ch;
      const float4 a = *reinterpret_cast<const float4*>(o), b = *reinterpret_cast<const float4*>(o + 4);
      *reinterpret_cast<uint4*>(ao + tok[i] + h * kD + 8 * ch) =
          make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                     pack_bf16x2(b.z, b.w));
    }
    __syncthreads();  // out shares the stages' space, and the tiles are rewritten next
  }
}

// The attention half's forward, three kernels (launch_attn_fwd):
//  1. attn_half_fwd_ao_kernel: attn_half_ao, ao (bf16, T x C) at the tokens'
//     own rows of x's (rows, C) view;
//  2. attn_half_fwd_proj_kernel: pre = ao·Wprojᵀ + bproj in f32 (T x C), on
//     gemm_tc.cuh's tiled core;
//  3. ln_resid_fwd_kernel (gemm_tc.cuh), one warp a row: LayerNorm of pre,
//     and x + s[image]·y where s is given, rounded to bf16 once.
// ao and pre sit at the tokens' own rows, so kernels 2 and 3 are plain row
// kernels over x's view: no gather, no scatter. None of the three grows with
// C, which they take at run time.
template <typename Layout>
__global__ void __launch_bounds__(kTcThreads, 2)
attn_half_fwd_ao_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                        const float* __restrict__ bqkv, const float* __restrict__ scale,
                        const float* __restrict__ z, int nwz, bf16* __restrict__ ao, int nwin,
                        int per_block, Layout lay, int C, int heads) {
  attn_half_ao(x, wqkv, bqkv, scale, z, nwz, ao, nwin, per_block, lay, C, heads);
}

template <int BN>
__global__ void __launch_bounds__(kGemmThreads)
attn_half_fwd_proj_kernel(const bf16* __restrict__ ao, const bf16* __restrict__ wproj,
                          const float* __restrict__ bproj, float* __restrict__ pre, int T, int C) {
  linear_f32_tile<BN>(ao, wproj, bproj, pre, T, C, C);
}

// Dynamic shared memory of the forward's kernels at width C: 0 the attention
// output, 1 proj, 2 the LayerNorm pass.
inline size_t attn_fwd_smem(int kernel, int C) {
  if (kernel == 0) return AoSmem::bytes;
  if (kernel == 1) return tile_cols(C) == 128 ? fc_smem<128>() : fc_smem<kBN>();
  return 0;
}

// x, out (rows, C) bf16 through the layout; ao (rows, C) bf16 and pre (rows,
// C) f32 scratch; s (B) or null. Blocks of kernel 1: (chunks·nwz, heads),
// chunk k covering u in [k·per_block, (k + 1)·per_block).
template <typename Layout>
int launch_attn_fwd(const bf16* x, const bf16* wqkv, const float* bqkv, const float* scale,
                    const float* z, int nwz, const bf16* wproj, const float* bproj,
                    const float* lns, const float* lnb, const float* s, bf16* out, bf16* ao,
                    float* pre, int per_block, int chunks, int B, Layout lay, int C, int heads,
                    cudaStream_t st) {
  const int n = lay.n(), nw = lay.windows(), nwin = B * nw, T = nwin * n;
  if (n < 1 || n > kTcRows || C != heads * kD || !ln_width_ok(C) || per_block < 1 || chunks < 1)
    return -1;
  int err;
  auto aok = attn_half_fwd_ao_kernel<Layout>;
  if ((err = allow_smem(aok, AoSmem::bytes))) return err;
  aok<<<dim3(chunks * nwz, heads), kTcThreads, AoSmem::bytes, st>>>(x, wqkv, bqkv, scale, z, nwz,
                                                                    ao, nwin, per_block, lay, C,
                                                                    heads);
  if ((err = (int)cudaGetLastError())) return err;
  const int row_tiles = (T + kBM - 1) / kBM;
  if (tile_cols(C) == 128) {
    if ((err = allow_smem(attn_half_fwd_proj_kernel<128>, fc_smem<128>()))) return err;
    attn_half_fwd_proj_kernel<128><<<dim3(C / 128, row_tiles), kGemmThreads, fc_smem<128>(), st>>>(
        ao, wproj, bproj, pre, T, C);
  } else {
    attn_half_fwd_proj_kernel<kBN><<<dim3((C + kBN - 1) / kBN, row_tiles), kGemmThreads,
                                     fc_smem<kBN>(), st>>>(ao, wproj, bproj, pre, T, C);
  }
  if ((err = (int)cudaGetLastError())) return err;
  return ln_resid_fwd(pre, lns, lnb, x, s, nw * n, out, nullptr, T, C, st);
}

}  // namespace hvt
