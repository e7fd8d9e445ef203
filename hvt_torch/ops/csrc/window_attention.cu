// window_attention_packed_fwd: cosine window attention on the packed qkv
// projection, (nWB, N, 3C) -> (nWB, N, C).
//
// Replaces: hvt/ops/window_attention_pallas.py `_packed_forward` (the
// pallas_call at line 473; body `_packed_fwd_kernel` -> `packed_heads_forward`).
//
// What bounds it on the H100: the bytes. Per (window, head) it reads 3·N·D
// inputs and writes N·D outputs (bf16: 12.5 KB in, 3 KB out at N=49, D=32)
// for 4·N²·D = 0.3 MFLOP, about 20 FLOP per byte, far below the card's
// ~295 FLOP/byte balance point for bf16 tensor cores. At SwinV2-T shapes and
// batch 64, the 12 launches of one forward move ~0.74 GB (0.22 ms at 3.35 TB/s).
//
// Design: one block per (window, head). The head's q, k, v are gathered
// straight from the packed layout into shared memory (no head-split
// transpose ever reaches device memory, like the TPU kernel), normalized,
// and the N x N logits, softmax and P·v stay in shared memory in f32, so
// device memory sees qkv once and the output once. The N x N work runs on
// CUDA cores in f32 (N = 49 fits no tensor-core tile without 30% padding,
// and the kernel is bound by bytes, not operations).
#include "common.cuh"

namespace hvt {

template <typename T>
__global__ void __launch_bounds__(128)
packed_attention_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ scale,
                            const float* __restrict__ z, int nwz, T* __restrict__ out, int n,
                            int c, int heads) {
  extern __shared__ float smem[];
  const int d = c / heads, ld = d + 1;
  float* Q = smem;
  float* K = Q + n * ld;
  float* V = K + n * ld;
  float* S = V + n * ld;
  const int w = blockIdx.x, h = blockIdx.y;
  const T* src = qkv + (size_t)w * n * 3 * c + h * d;
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int i = e / d, j = e - i * d;
    const T* row = src + (size_t)i * 3 * c + j;
    Q[i * ld + j] = to_f32(row[0]);
    K[i * ld + j] = to_f32(row[c]);
    V[i * ld + j] = to_f32(row[2 * c]);
  }
  __syncthreads();
  // window id = row mod nW (batch-major rows), as _packed_forward's z index map
  const float* zh = z + ((size_t)(w % nwz) * heads + h) * n * n;
  T* dst = out + (size_t)w * n * c + h * d;
  cosine_attention(Q, K, V, ld, S, n, d, scale[h], zh,
                   [&](int i, int j, float o) { dst[(size_t)i * c + j] = from_f32<T>(o); });
}

template <typename T>
int launch_packed(const void* qkv, const float* scale, const float* z, int nwz, void* out,
                  int nwb, int n, int c, int heads, cudaStream_t stream) {
  const int d = c / heads;
  const size_t smem = sizeof(float) * (3 * n * (d + 1) + n * (n + 1));
  auto kernel = packed_attention_fwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(nwb, heads), 128, smem, stream>>>(static_cast<const T*>(qkv), scale, z, nwz,
                                                   static_cast<T*>(out), n, c, heads);
  return (int)cudaGetLastError();
}

}  // namespace hvt

// dtype: 0 = bf16, 1 = f32 (qkv and out share it). Returns a cudaError_t.
extern "C" int hvt_window_attention_packed_fwd(const void* qkv, const float* scale,
                                               const float* z, int nwz, void* out, int nwb,
                                               int n, int c, int heads, int dtype,
                                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return hvt::launch_packed<hvt::bf16>(qkv, scale, z, nwz, out, nwb, n, c, heads, s);
  return hvt::launch_packed<float>(qkv, scale, z, nwz, out, nwb, n, c, heads, s);
}
