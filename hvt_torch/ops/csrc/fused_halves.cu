// The fused SwinV2 block halves, forward (serving, and training's forward):
//
//   mlp_half_fwd:            x (T, C) -> x + s·LN(fc2(GELU(fc1 x)))   [or the branch alone]
//   mlp_half_chunked_fwd:    the branch and its pre-LN sum, for the chunked backward
//   attention_half_nhwc_fwd: x (B, H, W, C) -> x + s·LN(proj(attn(qkv(window(x)))))
//
// Replace: hvt/ops/fused_halves_pallas.py `_mlp_forward` (pallas_call at
// line 338, body `_mlp_fwd_kernel`), `_mlp_chunked_forward` (pallas_call at
// line 592, body `_mlp_chunk_fwd_kernel`) and `_attn_forward_nhwc`
// (pallas_call at line 1330, body `_attn_fwd_kernel_nhwc` ->
// `_attn_half_fwd_body`).
//
// What bounds them on the H100: the operations. Per token the MLP half does
// 16·C² FLOP for 4·C bytes of bf16 in and out (384 FLOP/byte at C = 96,
// 3072 at C = 768), and the attention half 8·C² + 4·N·C FLOP for the same
// bytes; both sit above the ~295 FLOP/byte balance point of bf16 tensor
// cores, so the floor is the tensor-core rate.
//
// MLP half (this file): a block owns 32 rows. The 4C hidden dim is streamed
// in chunks of 32: fc1 of the chunk -> bias -> GELU (the A&S erf polynomial
// of _gelu) -> bf16 in shared memory -> accumulated into the 32 x C fc2
// result, which stays in registers across chunks. No (T, 4C) hidden ever
// reaches device memory. LayerNorm and the residual run in the epilogue.
// Products on mma.sync m16n8k16 (bf16 in, f32 accumulate: the TPU kernels'
// _dot contract); weight tiles stream through shared memory in slices of 32
// along k, without a cp.async pipeline.
//
// Attention half (fused_halves.cuh, launch_attn_fwd): three kernels whose
// tiles do not grow with C. (1) The attention output, one block of 4 warps
// per (chunk of windows, window id, head): the window's tokens gathered
// straight from the NHWC map, the cyclic shift folded into the gather index
// ((y + shift) mod H), so neither torch.roll nor window_partition exists on
// this path; the head's q|k|v on tensor cores with C streamed by two-stage
// cp.async, the f32 cosine core on tensor cores (attention_fwd_tc.cuh, P
// kept f32), ao stored bf16 at the tokens' own rows. The backward recomputes
// ao with the same device code. (2) proj = ao·Wprojᵀ + b into an f32 (T, C)
// buffer on gemm_tc.cuh's tiled core. (3) LayerNorm and the residual, one
// warp a row. The ao (bf16) and pre (f32) round trips add 12 bytes per
// token-channel to x's 4: the design's byte floor. attention_half.cu builds
// the same kernels on pre-partitioned windows, hvt's other entry.
// Weights arrive in nn.Linear's (out, in) layout, so both operands of every
// product keep the reduction dim contiguous.
#include "fused_halves.cuh"

namespace hvt {

// ---------------------------------------------------------------------------
// MLP half
// ---------------------------------------------------------------------------

// kPre: the chunked MLP's forward (hvt's `_mlp_chunked_forward`, pallas_call
// at line 592): also store the pre-LN sum, rounded to x's dtype, for the
// backward's LayerNorm (mlp_bwd.cu). hvt streams the hidden dim
// in K chunks to bound its VMEM; mlp_fc_chunks already streams it in chunks
// of 32 into an f32 sum, so the result does not depend on K.
template <int C, bool kPre>
__global__ void __launch_bounds__(kThreads)
mlp_half_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const float* __restrict__ b1, const bf16* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ lns,
                    const float* __restrict__ lnb, const float* __restrict__ s, int tpi,
                    bf16* __restrict__ out, bf16* __restrict__ pre, int T) {
  using L = MlpSmem<C>;
  constexpr int BM = L::BM, LDX = L::LDX, NT = C / 32;
  extern __shared__ uint4 smem_u4[];
  char* smem = reinterpret_cast<char*>(smem_u4);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L::x);
  float* red = reinterpret_cast<float*>(smem + L::red);
  const int row0 = blockIdx.x * BM;

  copy_rows(Xs, LDX, BM, C, [&](int r) -> const bf16* {
    return row0 + r < T ? x + (size_t)(row0 + r) * C : nullptr;
  });
  float acc[NT][4];
  mlp_fc_chunks<C>(acc, Xs, reinterpret_cast<bf16*>(smem + L::w1),
                   reinterpret_cast<bf16*>(smem + L::w2), reinterpret_cast<bf16*>(smem + L::h),
                   w1, b1, w2);

  if constexpr (kPre) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r_lo = (warp >> 2) * 16 + (lane >> 2);
    const int c0 = (warp & 3) * (C / 4) + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = c0 + j * 8;
      const float bb0 = b2[col], bb1 = b2[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + r_lo + 8 * half;
        if (row < T)
          *reinterpret_cast<uint32_t*>(pre + (size_t)row * C + col) =
              pack_bf16x2(acc[j][2 * half] + bb0, acc[j][2 * half + 1] + bb1);
      }
    }
  }
  ln_epilogue<NT>(acc, b2, lns, lnb, red, [&](int r, int col, float y0, float y1) {
    const int row = row0 + r;
    if (row >= T) return;
    if (s != nullptr) {
      const float sc = s[row / tpi];
      const bf16* xr = Xs + r * LDX + col;
      y0 = to_f32(xr[0]) + sc * y0;
      y1 = to_f32(xr[1]) + sc * y1;
    }
    *reinterpret_cast<uint32_t*>(out + (size_t)row * C + col) = pack_bf16x2(y0, y1);
  });
}

template <int C, bool kPre = false>
int launch_mlp(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
               const float* lns, const float* lnb, const float* s, int tpi, void* out, int T,
               cudaStream_t stream, void* pre = nullptr) {
  constexpr size_t smem = MlpSmem<C>::bytes;
  auto kernel = mlp_half_fwd_kernel<C, kPre>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (T + MlpSmem<C>::BM - 1) / MlpSmem<C>::BM;
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2), b2, lns, lnb, s, tpi, static_cast<bf16*>(out),
      static_cast<bf16*>(pre), T);
  return (int)cudaGetLastError();
}

}  // namespace hvt

// Widths built: SwinV2-T's four stages here; fused_halves_base.cu defines
// SwinV2-B's before including this file. Another width returns -1.
#ifndef HVT_WIDTHS
#define HVT_WIDTHS(F) F(96) F(192) F(384) F(768)
#define HVT_CHUNKED_WIDTHS(F)
#endif

extern "C" int hvt_mlp_half_fwd(const void* x, const void* w1, const float* b1, const void* w2,
                                const float* b2, const float* lns, const float* lnb,
                                const float* s, int tpi, void* out, int t, int c,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
#define HVT_CASE(CC) \
  case CC:           \
    return hvt::launch_mlp<CC>(x, w1, b1, w2, b2, lns, lnb, s, tpi, out, t, st);
    HVT_WIDTHS(HVT_CASE)
#undef HVT_CASE
    default:
      return -1;
  }
}

// The chunked MLP's forward: the MLP kernel above with kPre and no residual.
// x, out, pre (T, C) bf16; w1 (4C, C), w2 (C, 4C) bf16; b1, b2, lns, lnb
// f32. out = the branch, pre = the pre-LN sum. Returns a cudaError_t, or -1.
extern "C" int hvt_mlp_half_chunked_fwd(const void* x, const void* w1, const float* b1,
                                        const void* w2, const float* b2, const float* lns,
                                        const float* lnb, void* out, void* pre, int t, int c,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
#define HVT_CASE(CC)                                                                          \
  case CC:                                                                                    \
    return hvt::launch_mlp<CC, true>(x, w1, b1, w2, b2, lns, lnb, nullptr, 1, out, t, st, pre);
    HVT_CHUNKED_WIDTHS(HVT_CASE)
#undef HVT_CASE
    default:
      return -1;
  }
}

// x, out (B, H, W, C) bf16, un-rolled (the shift is folded into the window
// gather), 16-byte aligned; wqkv (3C, C), wproj (C, C) bf16; bqkv, scale
// (heads), z (nwz, heads, N, N), bproj, lns, lnb, s (B) f32 (s null: the
// branch alone, no residual). Scratch: ao (T, C) bf16 and pre (T, C) f32, T
// = B·H·W. Chunk k of the attention-output kernel covers windows u·nwz + wz
// for u in [k·per_block, min((k+1)·per_block, B·nW/nwz)). Returns a
// cudaError_t, or -1 for a width not built here.
extern "C" int hvt_attention_half_nhwc_fwd(const void* x, const void* wqkv, const float* bqkv,
                                           const float* scale, const float* z, int nwz,
                                           const void* wproj, const float* bproj,
                                           const float* lns, const float* lnb, const float* s,
                                           void* out, void* ao, float* pre, int per_block,
                                           int chunks, int b, int h, int w, int c, int heads,
                                           int ws, int shift, void* stream) {
  switch (c) {
#define HVT_CASE(CC) case CC:
    HVT_WIDTHS(HVT_CASE)
#undef HVT_CASE
    break;
    default:
      return -1;
  }
  using hvt::bf16;
  return hvt::launch_attn_fwd(static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), bqkv,
                              scale, z, nwz, static_cast<const bf16*>(wproj), bproj, lns, lnb, s,
                              static_cast<bf16*>(out), static_cast<bf16*>(ao), pre, per_block,
                              chunks, b, hvt::NhwcWindows{h, w, ws, shift}, c, heads,
                              static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory a block of the attention half's forward kernels takes
// at width c (both layouts): kernel 0 the attention output, 1 proj, 2 the
// LayerNorm pass; -1 for another kernel.
extern "C" int hvt_attention_half_fwd_smem(int kernel, int c) {
  return kernel >= 0 && kernel < 3 ? (int)hvt::attn_fwd_smem(kernel, c) : -1;
}
