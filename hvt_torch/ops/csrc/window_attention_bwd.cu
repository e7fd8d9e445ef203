// window_attention_packed_bwd: backward of the cosine window attention on the
// packed qkv projection, (qkv (nWB, N, 3C), dO (nWB, N, C)) ->
// (dqkv (nWB, N, 3C), dz (nWZ, H, N, N) f32, dscale (H,) f32).
//
// Replaces: hvt/ops/window_attention_pallas.py `_packed_backward` (the
// pallas_call at line 558; body `_packed_bwd_kernel` -> `packed_heads_backward`).
//
// Per (window, head), in f32, recomputed from qkv as the TPU kernel does:
//   q̂ = q·rsqrt(Σq² + 1e-24), k̂ likewise, cos = q̂k̂ᵀ, P = softmax(scale·cos + z)
//   dv = Pᵀ·dO,  dS = P ⊙ (dO·vᵀ − rowsum(dO·vᵀ ⊙ P))
//   dz += dS (summed over the windows that share a window id), dscale += Σ dS ⊙ cos
//   dq̂ = scale·dS·k̂, dk̂ = scale·dSᵀ·q̂, dq = (dq̂ − q̂⟨dq̂, q̂⟩)·rsqrt(Σq² + 1e-24), dk likewise.
//
// What bounds it on the H100: the bytes. Per token it reads qkv (3C) and dO
// (C) and writes dqkv (3C): 7C values, 14C bytes in bf16 (≈ 2.6 GB for the
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
// no tensor-core tile without 30% padding); dqkv is rounded to qkv's dtype
// once, at the store, and dz and dscale stay f32.
#include "common.cuh"

namespace hvt {

constexpr int kBwdThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
packed_attention_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                            const float* __restrict__ scale, const float* __restrict__ z,
                            int nwz, T* __restrict__ dqkv, float* __restrict__ dz_part,
                            float* __restrict__ ds_part, int nb, int per_block, int n, int c,
                            int heads) {
  extern __shared__ float smem[];
  const int d = c / heads, ld = d + 1, ldS = n + 1;
  float* Q = smem;           // q̂
  float* K = Q + n * ld;     // k̂
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
    // window id = row mod nWZ (batch-major rows), as _packed_backward's index map
    const size_t w = (size_t)b * nwz + wz;
    const T* src = qkv + w * n * 3 * c + h * d;
    const T* gsrc = dout + w * n * c + h * d;
    T* dst = dqkv + w * n * 3 * c + h * d;
    __syncthreads();  // the previous window's last readers are done
    for (int e = tid; e < n * d; e += blockDim.x) {
      const int i = e / d, j = e - i * d;
      const T* row = src + (size_t)i * 3 * c + j;
      Q[i * ld + j] = to_f32(row[0]);
      K[i * ld + j] = to_f32(row[c]);
      V[i * ld + j] = to_f32(row[2 * c]);
      G[i * ld + j] = to_f32(gsrc[(size_t)i * c + j]);
    }
    __syncthreads();
    for (int r = warp; r < 2 * n; r += nwarps) {
      float* v = r < n ? Q + r * ld : K + (r - n) * ld;
      float ss = 0.f;
      for (int cc = lane; cc < d; cc += 32) ss += v[cc] * v[cc];
      const float inv = rsqrtf(warp_sum(ss) + 1e-24f);
      for (int cc = lane; cc < d; cc += 32) v[cc] *= inv;
      if (lane == 0) {
        if (r < n) invQ[r] = inv;
        else invK[r - n] = inv;
      }
    }
    __syncthreads();
    for (int e = tid; e < n * n; e += blockDim.x) {
      const int i = e / n, j = e - i * n;
      const float* q = Q + i * ld;
      const float* k = K + j * ld;
      const float* g = G + i * ld;
      const float* v = V + j * ld;
      float dot = 0.f, dp = 0.f;
      for (int cc = 0; cc < d; ++cc) {
        dot += q[cc] * k[cc];
        dp += g[cc] * v[cc];
      }
      Cs[i * ldS + j] = dot;
      P[i * ldS + j] = dot * sc + zh[e];
      D[i * ldS + j] = dp;
    }
    __syncthreads();
    // softmax of each row, then dS = P ⊙ (dP − Σ_j dP ⊙ P)
    for (int i = warp; i < n; i += nwarps) {
      float* s = P + i * ldS;
      float* dp = D + i * ldS;
      float m = -INFINITY;
      for (int j = lane; j < n; j += 32) m = fmaxf(m, s[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float ex = expf(s[j] - m);
        s[j] = ex;
        sum += ex;
      }
      const float inv = 1.f / warp_sum(sum);
      float r = 0.f;
      for (int j = lane; j < n; j += 32) {
        s[j] *= inv;
        r += s[j] * dp[j];
      }
      r = warp_sum(r);
      for (int j = lane; j < n; j += 32) dp[j] = s[j] * (dp[j] - r);
    }
    __syncthreads();
    // dv = Pᵀ·dO, straight to the v columns of dqkv
    for (int e = tid; e < n * d; e += blockDim.x) {
      const int j = e / d, cc = e - j * d;
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc += P[i * ldS + j] * G[i * ld + cc];
      dst[(size_t)j * 3 * c + 2 * c + cc] = from_f32<T>(acc);
    }
    // dz and dscale: thread e owns Z[e] in every window of the chunk
    for (int e = tid; e < n * n; e += blockDim.x) {
      const int i = e / n, j = e - i * n;
      const float ds = D[i * ldS + j];
      Z[e] += ds;
      dscale += ds * Cs[i * ldS + j];
    }
    __syncthreads();  // v and dO are read for the last time above
    // dq̂ = scale·dS·k̂ into V, dk̂ = scale·dSᵀ·q̂ into G
    for (int e = tid; e < n * d; e += blockDim.x) {
      const int i = e / d, cc = e - i * d;
      float aq = 0.f, ak = 0.f;
      for (int j = 0; j < n; ++j) {
        aq += D[i * ldS + j] * K[j * ld + cc];
        ak += D[j * ldS + i] * Q[j * ld + cc];
      }
      V[i * ld + cc] = aq * sc;
      G[i * ld + cc] = ak * sc;
    }
    __syncthreads();
    // the norm's backward, one warp per row: dx = (dx̂ − x̂⟨dx̂, x̂⟩)·rsqrt(Σx² + 1e-24)
    for (int r = warp; r < 2 * n; r += nwarps) {
      const bool isq = r < n;
      const int i = isq ? r : r - n;
      const float* x = (isq ? Q : K) + i * ld;
      const float* gx = (isq ? V : G) + i * ld;
      float dot = 0.f;
      for (int cc = lane; cc < d; cc += 32) dot += gx[cc] * x[cc];
      dot = warp_sum(dot);
      const float inv = isq ? invQ[i] : invK[i];
      T* o = dst + (size_t)i * 3 * c + (isq ? 0 : c);
      for (int cc = lane; cc < d; cc += 32) o[cc] = from_f32<T>((gx[cc] - x[cc] * dot) * inv);
    }
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
__global__ void packed_attention_bwd_reduce(const float* __restrict__ dz_part,
                                            const float* __restrict__ ds_part,
                                            float* __restrict__ dz, float* __restrict__ dscale,
                                            int chunks, int nwz, int heads, int nn) {
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
int launch_packed_bwd(const void* qkv, const void* dout, const float* scale, const float* z,
                      int nwz, void* dqkv, float* dz, float* dscale, float* dz_part,
                      float* ds_part, int nwb, int n, int c, int heads, int per_block,
                      int chunks, cudaStream_t stream) {
  const int d = c / heads;
  const size_t smem =
      sizeof(float) * (4 * n * (d + 1) + 3 * n * (n + 1) + n * n + 2 * n + kBwdThreads / 32);
  auto kernel = packed_attention_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(chunks * nwz, heads), kBwdThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), scale, z, nwz,
      static_cast<T*>(dqkv), dz_part, ds_part, nwb / nwz, per_block, n, c, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)nwz * heads * n * n;
  const size_t work = total > (size_t)heads ? total : (size_t)heads;
  packed_attention_bwd_reduce<<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(
      dz_part, ds_part, dz, dscale, chunks, nwz, heads, n * n);
  return (int)cudaGetLastError();
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
