// Cosine window attention, forward, in two layouts:
//
//   window_attention_packed_fwd: on the packed qkv projection, (nWB, N, 3C) -> (nWB, N, C)
//   window_attention_fwd:        on split q, k, v, each (nWB, H, N, D) -> (nWB, H, N, D)
//
// Replace: hvt/ops/window_attention_pallas.py `_packed_forward` (the
// pallas_call at line 473; body `_packed_fwd_kernel` -> `packed_heads_forward`)
// and `_forward` (the pallas_call at line 107; body `_attention_kernel`).
//
// What bounds them on the H100: the bytes. Per (window, head) a kernel reads
// 3·N·D inputs and writes N·D outputs (bf16: 12.5 KB in, 3 KB out at N=49,
// D=32) for 4·N²·D = 0.3 MFLOP, about 20 FLOP per byte, far below the card's
// ~295 FLOP/byte balance point for bf16 tensor cores. At SwinV2-T shapes and
// batch 64, the 12 launches of one forward move ~0.74 GB (0.22 ms at 3.35 TB/s).
//
// Design: one block per (window, head). The head's q, k, v tiles are
// gathered into shared memory through their layout's strides (from the
// packed rows no head-split transpose ever reaches device memory, like the
// TPU kernel; the split layout's tiles are contiguous N x D), normalized,
// and the N x N logits, softmax and P·v stay in shared memory in f32, so
// device memory sees the inputs once and the output once. The N x N work
// runs on CUDA cores in f32 (N = 49 fits no tensor-core tile without 30%
// padding, and the kernels are bound by bytes, not operations). The two
// contracts differ in one rounding: hvt's split kernel rounds P to v's dtype
// before P·v (`attn.astype(v.dtype)`), the packed one keeps P in f32. The
// kernel, attention_fwd_kernel, is in common.cuh (swin_block.cu runs it too).
#include "common.cuh"

// dtype: 0 = bf16, 1 = f32 (qkv and out share it). Returns a cudaError_t.
extern "C" int hvt_window_attention_packed_fwd(const void* qkv, const float* scale,
                                               const float* z, int nwz, void* out, int nwb,
                                               int n, int c, int heads, int dtype,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = c / heads;
  const hvt::HeadTiles in{(long long)n * 3 * c, d, 3 * c}, ot{(long long)n * c, d, c};
  if (dtype == 0) {
    const hvt::bf16* p = static_cast<const hvt::bf16*>(qkv);
    return hvt::launch_attention<hvt::bf16>(p, p + c, p + 2 * c, in, scale, z, nwz, out, ot, nwb,
                                            n, d, heads, false, s);
  }
  const float* p = static_cast<const float*>(qkv);
  return hvt::launch_attention<float>(p, p + c, p + 2 * c, in, scale, z, nwz, out, ot, nwb, n, d,
                                      heads, false, s);
}

// q, k, v and out (nWB, H, N, D), all of one dtype: 0 = bf16 (P is rounded
// to bf16 before P·v, hvt's `attn.astype(v.dtype)`), 1 = f32. Returns a
// cudaError_t.
extern "C" int hvt_window_attention_fwd(const void* q, const void* k, const void* v,
                                        const float* scale, const float* z, int nwz, void* out,
                                        int nwb, int n, int d, int heads, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const hvt::HeadTiles tiles{(long long)heads * n * d, (long long)n * d, d};
  if (dtype == 0)
    return hvt::launch_attention<hvt::bf16>(q, k, v, tiles, scale, z, nwz, out, tiles, nwb, n, d,
                                            heads, true, s);
  return hvt::launch_attention<float>(q, k, v, tiles, scale, z, nwz, out, tiles, nwb, n, d, heads,
                                      false, s);
}
