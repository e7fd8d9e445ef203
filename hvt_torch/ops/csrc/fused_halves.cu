// The attention half of the fused SwinV2 block, forward (serving, and
// training's forward):
//
//   attention_half_nhwc_fwd: x (B, H, W, C) -> x + s·LN(proj(attn(qkv(window(x)))))
//
// Replaces: hvt/ops/fused_halves_pallas.py `_attn_forward_nhwc` (pallas_call
// at line 1330, body `_attn_fwd_kernel_nhwc` -> `_attn_half_fwd_body`). The
// MLP half's forward is mlp.cu.
//
// What bounds it on the H100: the operations. Per token the attention half
// does 8·C² + 4·N·C FLOP for 4·C bytes of bf16 in and out, above the ~295
// FLOP/byte balance point of bf16 tensor cores, so the floor is the
// tensor-core rate.
//
// Design (fused_halves.cuh, launch_attn_fwd): three kernels whose
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

// Widths built: SwinV2-T's four stages here; fused_halves_base.cu defines
// SwinV2-B's before including this file. Another width returns -1.
#ifndef HVT_WIDTHS
#define HVT_WIDTHS(F) F(96) F(192) F(384) F(768)
#endif

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
