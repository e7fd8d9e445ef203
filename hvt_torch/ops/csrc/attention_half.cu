// The attention half on pre-partitioned windows, forward and backward:
//
//   attention_half_fwd: x (nWB, N, C) -> LN(proj(attn(qkv(x))))   (the branch, no residual)
//   attention_half_bwd: every gradient of that branch given g
//
// Replace: hvt/ops/fused_halves_pallas.py `_attn_forward` (pallas_call at
// line 1216, body `_attn_fwd_kernel` -> `_attn_half_fwd_body`) and
// `_attn_backward` (pallas_call at line 1257, body `_attn_bwd_kernel` ->
// `_attn_half_bwd_body`), which hvt takes on `fuse: true, fuse_nhwc: false`
// (hvt/models/swinv2.py:392-399).
//
// hvt's windowed and NHWC entries share their bodies and differ only in the
// BlockSpecs that gather a window's tokens. So do these: the kernels are
// those of attention_half_nhwc (fused_halves.cuh's three forward kernels,
// fused_halves_bwd.cuh's backward), instantiated on the FlatWindows layout,
// where token i of window w is row w·N + i. Window id = w mod nWZ
// (batch-major windows), as `_attn_forward`'s BlockSpecs. hvt pads N to a
// multiple of 8 for the TPU's tiles (49 -> 56, -1e9 bias columns); the
// tensor-core tiles here read rows past N as zeros, so N is taken as it is.
// Arithmetic, bounds and design are the NHWC kernels' (see
// fused_halves.cu, fused_halves_bwd.cu); nothing is rolled or fused as a
// residual here: hvt's windowed kernel has neither.
//
// A library of its own, so that its nvcc runs beside those of the NHWC
// kernels; attention_half_base.cu builds it at SwinV2-B's widths.
#include "fused_halves_bwd.cuh"

#ifndef HVT_WIDTHS
#define HVT_WIDTHS(F) F(96) F(192) F(384) F(768)
#endif

// x, out (nWB, N, C) bf16, x 16-byte aligned; wqkv (3C, C), wproj (C, C)
// bf16; bqkv, scale (heads), z (nwz, heads, N, N), bproj, lns, lnb f32; nWB a
// multiple of nwz. Scratch: ao (nWB·N, C) bf16 and pre (nWB·N, C) f32; the
// chunks as hvt_attention_half_bwd's. Returns a cudaError_t, or -1 for a
// width not built here.
extern "C" int hvt_attention_half_fwd(const void* x, const void* wqkv, const float* bqkv,
                                      const float* scale, const float* z, int nwz,
                                      const void* wproj, const float* bproj, const float* lns,
                                      const float* lnb, void* out, void* ao, float* pre,
                                      int per_block, int chunks, int nwb, int n, int c, int heads,
                                      void* stream) {
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
                              scale, z, nwz, static_cast<const bf16*>(wproj), bproj, lns, lnb,
                              nullptr, static_cast<bf16*>(out), static_cast<bf16*>(ao), pre,
                              per_block, chunks, nwb / nwz, hvt::FlatWindows{nwz, n}, c, heads,
                              static_cast<cudaStream_t>(stream));
}

// x, g, dx (nWB, N, C) bf16; weights and z as the forward's. Outputs f32:
// dwqkv (3C, C), dwproj (C, C), dsmall = [dbqkv (3C) | dbproj | dlns |
// dlnb], dscale (heads), dz (nwz, heads, N, N). Scratch as
// hvt_attention_half_nhwc_bwd's: ao, dproj (T, C) and dqkv (T, 3C) bf16,
// T = nWB·N; part_a ceil(T/proj_rows)·3C, part_b chunks·nwz·3C, dz_part
// chunks·nwz·heads·N·N, ds_part chunks·nwz·heads floats; wpart
// max(splits)·3C·C floats. Chunk k of the tensor-core kernels covers
// windows u·nwz + wz for u in [k·per_block, min((k+1)·per_block, nWB/nwz)).
extern "C" int hvt_attention_half_bwd(
    const void* x, const void* wqkv, const float* bqkv, const float* scale, const float* z,
    int nwz, const void* wproj, const float* bproj, const float* lns, const void* g, void* dx,
    float* dwqkv, float* dwproj, float* dsmall, float* dscale, float* dz, void* ao, void* dproj,
    void* dqkv, float* part_a, float* part_b, float* dz_part, float* ds_part, float* wpart,
    int per_block, int chunks, int proj_rows, int splits_qkv, int splits_proj, int nwb, int n,
    int c, int heads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
#define HVT_CASE(CC)                                                                             \
  case CC:                                                                                       \
    return hvt::launch_attn_bwd<CC>(x, wqkv, bqkv, scale, z, nwz, wproj, bproj, lns, nullptr, g, \
                                    dx, dwqkv, dwproj, dsmall, dscale, dz, ao, dproj, dqkv,      \
                                    part_a, part_b, dz_part, ds_part, wpart, per_block, chunks,  \
                                    proj_rows, splits_qkv, splits_proj, nwb / nwz,               \
                                    hvt::FlatWindows{nwz, n}, heads, st);
    HVT_WIDTHS(HVT_CASE)
#undef HVT_CASE
    default:
      return -1;
  }
}
