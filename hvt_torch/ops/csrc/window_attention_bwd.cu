// Backward of the cosine window attention, in two layouts:
//
//   window_attention_packed_bwd: (qkv (nWB, N, 3C), dO (nWB, N, C)) ->
//                                (dqkv (nWB, N, 3C), dz (nWZ, H, N, N) f32, dscale (H,) f32)
//   window_attention_bwd:        (q, k, v, dO, each (nWB, H, N, D)) ->
//                                (dq, dk, dv (nWB, H, N, D), dz, dscale)
//
// Replace: hvt/ops/window_attention_pallas.py `_packed_backward` (the
// pallas_call at line 558; body `_packed_bwd_kernel` -> `packed_heads_backward`)
// and `_backward` (the pallas_call at line 246; body `_attention_bwd_kernel`).
// Both TPU bodies are the same f32 math; only the layouts differ, and the
// one kernel here reads and writes each through its strides (HeadTiles).
//
// Per (window, head), in f32, recomputed from qkv as the TPU kernel does:
//   q̂ = q·rsqrt(Σq² + 1e-24), k̂ likewise, cos = q̂k̂ᵀ, P = softmax(scale·cos + z)
//   dv = Pᵀ·dO,  dS = P ⊙ (dO·vᵀ − rowsum(dO·vᵀ ⊙ P))
//   dz += dS (summed over the windows that share a window id), dscale += Σ dS ⊙ cos
//   dq̂ = scale·dS·k̂, dk̂ = scale·dSᵀ·q̂, dq = (dq̂ − q̂⟨dq̂, q̂⟩)·rsqrt(Σq² + 1e-24), dk likewise.
//
// What bounds it on the H100: the bytes. Per token it reads q, k, v (3C) and
// dO (C) and writes their gradients (3C): 7C values, 14C bytes in bf16 (≈ 2.6 GB for the
// 12 launches of one SwinV2-T step at batch 128, ≈ 0.77 ms at 3.35 TB/s),
// for 10·N²·D FLOP per (window, head), about 35 FLOP per byte.
//
// Design. The TPU kernel carries dz and dscale across its sequential batch
// grid axis; blocks on Hopper run in no order, so that does not carry over,
// and per-window dz partials would be 236 MB at stage 1. Here one block owns
// (a chunk of `per_block` images, one window id, one head): it loops over the
// chunk's windows of that id, keeping the head's q̂, k̂, v, dO, P, dS and cos in
// dynamic shared memory (65 KB at N = 49, D = 32, above the 48 KB static
// limit) and the chunk's dz sum in shared memory (each thread owns the same
// elements in every window, so the sum needs no atomics). Each block writes
// one (N, N) dz partial and one dscale partial; a second kernel sums the
// partials over chunks in a fixed order. The result is deterministic, and
// the wrapper picks the chunk size so that every stage launches about 1,000
// blocks (about 2.5 waves of the 132 SMs at 3 resident blocks each, the
// shared memory's limit), including stage 4,
// where one block per (window id, head) would give 24 blocks. The partials
// cost ~10 MB of traffic at stage 1 against 0.5 GB of qkv, dO and dqkv.
// The N x N work runs on CUDA cores in f32 like the forward (N = 49 fits
// no tensor-core tile without 30% padding); dq, dk and dv are rounded to the
// inputs' dtype once, at the store, and dz and dscale stay f32.
#include "common.cuh"

namespace hvt {

constexpr int kBwdThreads = 256;

// q, k, v and their gradients in the layout `in`, dO in `go`.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     HeadTiles in, const T* __restrict__ dout, HeadTiles go,
                     const float* __restrict__ scale, const float* __restrict__ z, int nwz,
                     T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dz_part, float* __restrict__ ds_part, int nb,
                     int per_block, int n, int d, int heads) {
  extern __shared__ float smem[];
  const int ld = d + 1, ldS = n + 1;
  float* Q = smem;           // q, then q̂
  float* K = Q + n * ld;     // k, then k̂
  float* V = K + n * ld;     // v, then dq̂
  float* G = V + n * ld;     // dO, then dk̂
  float* P = G + n * ld;     // logits, then softmax
  float* D = P + n * ldS;    // dO·vᵀ, then dS
  float* Cs = D + n * ldS;   // cos = q̂k̂ᵀ
  float* Z = Cs + n * ldS;   // this block's dz sum, n x n
  float* invQ = Z + n * n;   // rsqrt(Σq² + 1e-24) per row
  float* invK = invQ + n;
  float* red = invK + n;     // one partial per warp

  const int wz = blockIdx.x % nwz, chunk = blockIdx.x / nwz, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float sc = scale[h];
  const float* zh = z + ((size_t)wz * heads + h) * n * n;
  for (int e = tid; e < n * n; e += blockDim.x) Z[e] = 0.f;
  float dscale = 0.f;

  const int b_end = min((chunk + 1) * per_block, nb);
  for (int b = chunk * per_block; b < b_end; ++b) {
    // window id = row mod nWZ (batch-major rows), as the TPU kernels' index maps
    const int w = b * nwz + wz;
    __syncthreads();  // the previous window's last readers are done
    for (int e = tid; e < n * d; e += blockDim.x) {
      const int i = e / d, j = e - i * d;
      const size_t off = in.at(w, h, i) + j;
      Q[i * ld + j] = to_f32(q[off]);
      K[i * ld + j] = to_f32(k[off]);
      V[i * ld + j] = to_f32(v[off]);
      G[i * ld + j] = to_f32(dout[go.at(w, h, i) + j]);
    }
    __syncthreads();
    attention_core_bwd(
        Q, K, V, G, P, D, Cs, Z, invQ, invK, n, d, ld, sc, zh, dscale,
        [&](int j, int cc, float val) { dv[in.at(w, h, j) + cc] = from_f32<T>(val); },
        [&](bool isq, int i, int cc, float val) {
          (isq ? dq : dk)[in.at(w, h, i) + cc] = from_f32<T>(val);
        });
  }

  const size_t part = ((size_t)chunk * nwz + wz) * heads + h;
  for (int e = tid; e < n * n; e += blockDim.x) dz_part[part * n * n + e] = Z[e];
  dscale = warp_sum(dscale);
  if (lane == 0) red[warp] = dscale;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < nwarps; ++i) s += red[i];
    ds_part[part] = s;
  }
}

// dz[e] = Σ_chunk dz_part[chunk][e] and dscale[h] = Σ_(chunk, wz) ds_part[chunk][wz][h],
// each summed in a fixed order.
__global__ void attention_bwd_reduce(const float* __restrict__ dz_part,
                                     const float* __restrict__ ds_part, float* __restrict__ dz,
                                     float* __restrict__ dscale, int chunks, int nwz, int heads,
                                     int nn) {
  const size_t total = (size_t)nwz * heads * nn;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total) {
    float s = 0.f;
    for (int ch = 0; ch < chunks; ++ch) s += dz_part[ch * total + idx];
    dz[idx] = s;
  }
  if (idx < (size_t)heads) {
    float s = 0.f;
    for (int p = 0; p < chunks * nwz; ++p) s += ds_part[(size_t)p * heads + idx];
    dscale[idx] = s;
  }
}

template <typename T>
int launch_attention_bwd(const void* q, const void* k, const void* v, HeadTiles in,
                         const void* dout, HeadTiles go, const float* scale, const float* z,
                         int nwz, void* dq, void* dk, void* dv, float* dz, float* dscale,
                         float* dz_part, float* ds_part, int nwb, int n, int d, int heads,
                         int per_block, int chunks, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * n * (d + 1) + 3 * n * (n + 1) + n * n + 2 * n + kBwdThreads / 32);
  auto kernel = attention_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(chunks * nwz, heads), kBwdThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), in,
      static_cast<const T*>(dout), go, scale, z, nwz, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), dz_part, ds_part, nwb / nwz, per_block, n, d, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)nwz * heads * n * n;
  const size_t work = total > (size_t)heads ? total : (size_t)heads;
  attention_bwd_reduce<<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      dz_part, ds_part, dz, dscale, chunks, nwz, heads, n * n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_packed_bwd(const void* qkv, const void* dout, const float* scale, const float* z,
                      int nwz, void* dqkv, float* dz, float* dscale, float* dz_part,
                      float* ds_part, int nwb, int n, int c, int heads, int per_block,
                      int chunks, cudaStream_t stream) {
  const int d = c / heads;
  const HeadTiles in{(long long)n * 3 * c, d, 3 * c}, go{(long long)n * c, d, c};
  const T* p = static_cast<const T*>(qkv);
  T* g = static_cast<T*>(dqkv);
  return launch_attention_bwd<T>(p, p + c, p + 2 * c, in, dout, go, scale, z, nwz, g, g + c,
                                 g + 2 * c, dz, dscale, dz_part, ds_part, nwb, n, d, heads,
                                 per_block, chunks, stream);
}

}  // namespace hvt

// dtype: 0 = bf16, 1 = f32 (qkv, dout and dqkv share it). dz_part holds
// chunks·nWZ·H·N·N floats and ds_part chunks·nWZ·H; chunk k covers images
// [k·per_block, min((k+1)·per_block, nWB/nWZ)). Returns a cudaError_t.
extern "C" int hvt_window_attention_packed_bwd(const void* qkv, const void* dout,
                                               const float* scale, const float* z, int nwz,
                                               void* dqkv, float* dz, float* dscale,
                                               float* dz_part, float* ds_part, int nwb, int n,
                                               int c, int heads, int per_block, int chunks,
                                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return hvt::launch_packed_bwd<hvt::bf16>(qkv, dout, scale, z, nwz, dqkv, dz, dscale, dz_part,
                                             ds_part, nwb, n, c, heads, per_block, chunks, s);
  return hvt::launch_packed_bwd<float>(qkv, dout, scale, z, nwz, dqkv, dz, dscale, dz_part,
                                       ds_part, nwb, n, c, heads, per_block, chunks, s);
}

// q, k, v, dout and dq, dk, dv (nWB, H, N, D), all of one dtype: 0 = bf16,
// 1 = f32; nWB a multiple of nWZ. Scratch and chunks as the packed entry's.
// Returns a cudaError_t.
extern "C" int hvt_window_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* dout, const float* scale, const float* z,
                                        int nwz, void* dq, void* dk, void* dv, float* dz,
                                        float* dscale, float* dz_part, float* ds_part, int nwb,
                                        int n, int d, int heads, int per_block, int chunks,
                                        int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const hvt::HeadTiles tiles{(long long)heads * n * d, (long long)n * d, d};
  if (dtype == 0)
    return hvt::launch_attention_bwd<hvt::bf16>(q, k, v, tiles, dout, tiles, scale, z, nwz, dq,
                                                dk, dv, dz, dscale, dz_part, ds_part, nwb, n, d,
                                                heads, per_block, chunks, s);
  return hvt::launch_attention_bwd<float>(q, k, v, tiles, dout, tiles, scale, z, nwz, dq, dk, dv,
                                          dz, dscale, dz_part, ds_part, nwb, n, d, heads,
                                          per_block, chunks, s);
}
