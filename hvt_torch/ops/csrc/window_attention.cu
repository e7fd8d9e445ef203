// Cosine window attention, forward, in two layouts:
//
//   window_attention_packed_fwd: on the packed qkv projection, (nWB, N, 3C) -> (nWB, N, C)
//   window_attention_fwd:        on split q, k, v, each (nWB, H, N, D) -> (nWB, H, N, D)
//
// Replace: hvt/ops/window_attention_pallas.py `_packed_forward` (the
// pallas_call at line 473; body `_packed_fwd_kernel` -> `packed_heads_forward`)
// and `_forward` (the pallas_call at line 107; body `_attention_kernel`).
// The two contracts differ in one rounding: hvt's split kernel rounds P to
// v's dtype before P·v (`attn.astype(v.dtype)`), the packed one keeps P in
// f32. The output is in the inputs' dtype, bf16 or f32.
//
// What bounds them on the H100: the bytes. Per (window, head) a kernel reads
// 3·N·D inputs and writes N·D outputs (bf16: 9.4 KB in, 3.1 KB out at N=49,
// D=32) and the (N, N) f32 z, for 4·N²·D = 0.3 MFLOP, about 20 FLOP per
// byte, far below the card's ~295 FLOP/byte balance point for bf16 tensor
// cores. At SwinV2-T shapes and batch 64, the 12 launches of one forward
// move ~0.74 GB (0.22 ms at 3.35 TB/s).
//
// Which device code runs is chosen by shape alone:
//   * head dim 32 and N <= 64 (every block of SwinV2-T, S and B at 224 px,
//     N = 49, and of swinv2_tiny_window8_256, N = 64): attention_fwd_tc_kernel
//     below, on tensor cores;
//   * any other shape whose f32 tiles fit 227 KB of shared memory (windows of
//     65-144 tokens at head dim 32, e.g. swinv2_large_window12_192's N = 144;
//     other head dims): attention_fwd_kernel (common.cuh, which swin_block.cu
//     runs too), one block per (window, head) with the N x N logits, softmax
//     and P·v in f32 shared memory on CUDA cores.
//
// attention_fwd_tc_kernel. The byte-bound design of the backward
// (window_attention_bwd.cu): one block of four warps owns (a chunk of
// `per_block` images, one window id, one head), loads that (window id,
// head)'s z into shared memory once (times log2 e, -inf at padded keys and
// rows), and loops over the chunk's windows of that id. Each window's q, k
// and v tiles (N <= 64 rows of D = 32, zero-padded to 64 rows, XOR-swizzled;
// from the packed rows no head-split transpose ever reaches device memory)
// arrive by cp.async in 16-byte pieces into one of two buffers, so the next
// window loads while this one computes (f32 inputs are split into three bf16
// pieces on the way in, synchronously). The kernel and its launcher live in
// attention_fwd_tc.cuh, which the retired block halves (swin_block.cu)
// share; the per-window math is attention_window_fwd_tc there: both products
// on mma.sync with the normalisation folded out, the softmax in registers,
// P·v from the logit accumulators, f32 accuracy from bf16 pieces. Device
// memory sees the inputs once, the output once (rounded once, at the
// store), and z once a block. Shared memory: 43,520 B a block in bf16,
// 92,672 B in f32. The wrapper (window_attention_cuda.tc_forward_chunks)
// sizes the chunks.
#include "attention_fwd_tc.cuh"

// dtype: 0 = bf16, 1 = f32 (qkv and out share it). Head dim 32 and N <= 64
// run attention_fwd_tc_kernel, one block per (chunk k of images, window id,
// head), chunk k covering images [k·per_block, (k+1)·per_block) (image b =
// windows b·nWZ ..); other shapes run attention_fwd_kernel, which ignores
// per_block and chunks. Returns a cudaError_t.
extern "C" int hvt_window_attention_packed_fwd(const void* qkv, const float* scale,
                                               const float* z, int nwz, void* out, int nwb,
                                               int n, int c, int heads, int per_block, int chunks,
                                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = c / heads;
  const hvt::HeadTiles in{(long long)n * 3 * c, d, 3 * c}, ot{(long long)n * c, d, c};
  const bool tc = hvt::tc_forward_takes(n, d);
  if (dtype == 0) {
    const hvt::bf16* p = static_cast<const hvt::bf16*>(qkv);
    if (tc)
      return hvt::launch_attention_fwd_tc<hvt::bf16, false>(p, p + c, p + 2 * c, in, scale, z,
                                                            nwz, out, ot, nwb, n, heads,
                                                            per_block, chunks, s);
    return hvt::launch_attention<hvt::bf16>(p, p + c, p + 2 * c, in, scale, z, nwz, out, ot, nwb,
                                            n, d, heads, false, s);
  }
  const float* p = static_cast<const float*>(qkv);
  if (tc)
    return hvt::launch_attention_fwd_tc<float, false>(p, p + c, p + 2 * c, in, scale, z, nwz, out,
                                                      ot, nwb, n, heads, per_block, chunks, s);
  return hvt::launch_attention<float>(p, p + c, p + 2 * c, in, scale, z, nwz, out, ot, nwb, n, d,
                                      heads, false, s);
}

// q, k, v and out (nWB, H, N, D), all of one dtype: 0 = bf16 (P is rounded
// to bf16 before P·v, hvt's `attn.astype(v.dtype)`), 1 = f32. Kernels,
// per_block and chunks as the packed entry's. Returns a cudaError_t.
extern "C" int hvt_window_attention_fwd(const void* q, const void* k, const void* v,
                                        const float* scale, const float* z, int nwz, void* out,
                                        int nwb, int n, int d, int heads, int per_block,
                                        int chunks, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const hvt::HeadTiles tiles{(long long)heads * n * d, (long long)n * d, d};
  const bool tc = hvt::tc_forward_takes(n, d);
  if (dtype == 0) {
    if (tc)
      return hvt::launch_attention_fwd_tc<hvt::bf16, true>(q, k, v, tiles, scale, z, nwz, out,
                                                           tiles, nwb, n, heads, per_block,
                                                           chunks, s);
    return hvt::launch_attention<hvt::bf16>(q, k, v, tiles, scale, z, nwz, out, tiles, nwb, n, d,
                                            heads, true, s);
  }
  if (tc)
    return hvt::launch_attention_fwd_tc<float, false>(q, k, v, tiles, scale, z, nwz, out, tiles,
                                                      nwb, n, heads, per_block, chunks, s);
  return hvt::launch_attention<float>(q, k, v, tiles, scale, z, nwz, out, tiles, nwb, n, d, heads,
                                      false, s);
}

// Dynamic shared memory a block of attention_fwd_tc_kernel takes, dtype as above.
extern "C" int hvt_window_attention_fwd_smem(int dtype) {
  return dtype == 0 ? (int)hvt::tc_fwd_smem_bytes<hvt::bf16>()
                     : (int)hvt::tc_fwd_smem_bytes<float>();
}
