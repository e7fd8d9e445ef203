// The attention half of the fused SwinV2 block, backward (training on
// fuse: true):
//
//   hvt_attention_half_nhwc_bwd: gradients of out = x + s·LN(proj(attn(qkv(window(x)))))
//
// Replaces: hvt/ops/fused_halves_pallas.py `_attn_backward_nhwc`
// (pallas_call at line 1386, body `_attn_bwd_kernel_nhwc` ->
// `_attn_half_bwd_body` -> `_heads_bwd_from_cache`). The MLP half's backward
// is mlp.cu.
//
// Arithmetic contract, hvt's _dot/_dot_t: every product, the weight-gradient
// products included, rounds its operands to bf16 and accumulates in f32;
// LayerNorm and its backward run in f32 and the attention core to f32
// accuracy (tensor cores on bf16 pieces, below); dx is rounded to x's dtype
// once, at the store; weight, bias and LayerNorm-parameter gradients stay
// f32. As in hvt, s·g is rounded to bf16 before the branch backward.
// Nothing of the forward is saved: the kernels recompute it from x, as the
// TPU kernel does.
//
// What bounds it on the H100: the operations, (24·C² + 10·N·C)·T FLOP, far
// above the bf16 balance point.
//
// Design. The TPU kernel adds the weight gradients into VMEM across a
// sequential grid; Hopper's blocks run in no order, and per-row-block
// partials of whole weight gradients would be ~1.9 GB at every stage (T·C²
// is constant). Since the contract rounds both operands of every
// weight-gradient product to bf16, the kernels write those operands to
// device memory in bf16 (the attention output, dproj and dqkv) and
// `grad_tn` (gemm_tc.cuh), a tensor-core AᵀB over the tokens split into a
// fixed number of slices, forms each weight gradient, `sum_parts_kernel`
// summing the slices in a fixed order. Bias, LayerNorm-parameter, dz and
// dscale gradients reduce the same way: one f32 partial per block, summed in
// a fixed order. Every result is deterministic (no atomics).
//  Four kernels and the reductions (fused_halves_bwd.cuh, templated on the
//  token layout, which attention_half.cu builds on pre-partitioned
//  windows). The attention core's recompute and backward run on tensor
//    cores at f32 accuracy (attention_fwd_tc.cuh, attention_bwd_tc.cuh): q,
//    k, v and dao enter as three bf16 pieces each, P and the scaled dS as
//    bf16 hi + lo halves, the normalisation folded out of the products.
//    `attn_half_bwd_ao_kernel` (one block of 4 warps per chunk of windows,
//    window id and head) recomputes the head's q|k|v on tensor cores, C
//    streamed in slices by cp.async, and its attention output, which it
//    stores (bf16) at the tokens' own rows. `attn_half_bwd_proj_kernel`
//    (32 token rows at a time) forms proj from it and the LayerNorm
//    backward gives dproj. `attn_half_bwd_core_kernel` (blocks as the first
//    kernel's) recomputes q|k|v and dao = dproj·Wproj_h in one stream over
//    C and runs the core's backward: dqkv goes out in bf16, the chunk's dz
//    and dscale stay in registers. `attn_half_bwd_dx_kernel` forms dx = g +
//    dqkv·Wqkv per row. The first and third kernels' tiles do not grow with
//    C, which they take at run time. All per-token buffers are indexed by
//    the token's own NHWC position, so nothing is rolled or partitioned,
//    and dx, the un-rolled map, needs no scatter. Then dWqkv = Σ dqkvᵀx
//    and dWproj = Σ dprojᵀ·attn_out.
//  Rows 49-63 of a window's 64-row tensor-core tile are zeros and are
//  never stored, so they reach no gradient.
#include "fused_halves_bwd.cuh"

// Widths built: SwinV2-T's four stages here; fused_halves_bwd_base.cu
// defines SwinV2-B's before including this file. Another width returns -1.
#ifndef HVT_WIDTHS
#define HVT_WIDTHS(F) F(96) F(192) F(384) F(768)
#endif

// x, g, dx (B, H, W, C) bf16, un-rolled (the shift is folded into the
// window gather); wqkv (3C, C), wproj (C, C) bf16; bqkv, scale (heads),
// z (nwz, heads, N, N), bproj, lns, s f32 (s null: no fused residual).
// Outputs f32: dwqkv (3C, C), dwproj (C, C), dsmall = [dbqkv (3C) | dbproj
// | dlns | dlnb], dscale (heads), dz (nwz, heads, N, N). Scratch: ao, dproj
// (T, C) and dqkv (T, 3C) bf16; part_b chunks·nwz·3C,
// dz_part chunks·nwz·heads·N·N, ds_part chunks·nwz·heads floats; wpart
// max(splits)·3C·C floats; part_a ceil(T/proj_rows)·3C floats, T = B·H·W.
// Chunk k of the tensor-core kernels covers windows u·nwz + wz for u in
// [k·per_block, min((k+1)·per_block, B·nW/nwz)); the proj kernel's blocks
// take proj_rows rows each (a multiple of 32).
extern "C" int hvt_attention_half_nhwc_bwd(
    const void* x, const void* wqkv, const float* bqkv, const float* scale, const float* z,
    int nwz, const void* wproj, const float* bproj, const float* lns, const float* s,
    const void* g, void* dx, float* dwqkv, float* dwproj, float* dsmall, float* dscale,
    float* dz, void* ao, void* dproj, void* dqkv, float* part_a, float* part_b, float* dz_part,
    float* ds_part, float* wpart, int per_block, int chunks, int proj_rows, int splits_qkv,
    int splits_proj, int b, int h, int w, int c, int heads, int ws, int shift, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
#define HVT_CASE(CC)                                                                            \
  case CC:                                                                                      \
    return hvt::launch_attn_bwd<CC>(x, wqkv, bqkv, scale, z, nwz, wproj, bproj, lns, s, g, dx, \
                                    dwqkv, dwproj, dsmall, dscale, dz, ao, dproj, dqkv, part_a, \
                                    part_b, dz_part, ds_part, wpart, per_block, chunks,         \
                                    proj_rows, splits_qkv, splits_proj, b,                      \
                                    hvt::NhwcWindows{h, w, ws, shift}, heads, st);
    HVT_WIDTHS(HVT_CASE)
#undef HVT_CASE
    default:
      return -1;
  }
}

// Dynamic shared memory a block of the attention half's backward kernels
// takes at width c (both layouts): kernel 0 the attention output, 1 the
// core, 2 proj and the LayerNorm backward; -1 for a width not built here.
extern "C" int hvt_attention_half_bwd_smem(int kernel, int c) {
  if (kernel == 0) return (int)hvt::AoSmem::bytes;
  if (kernel == 1) return (int)hvt::CoreSmem::bytes;
  switch (c) {
#define HVT_CASE(CC) \
  case CC:           \
    return (int)hvt::proj_smem_bytes<CC>();
    HVT_WIDTHS(HVT_CASE)
#undef HVT_CASE
    default:
      return -1;
  }
}
