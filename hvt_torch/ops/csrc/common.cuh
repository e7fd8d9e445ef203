// Shared device helpers for the hvt_torch Hopper kernels (sm_90a).
//
// The kernels are built by nvcc into shared libraries with a plain C
// interface (hvt_torch/ops/_build.py) and called through ctypes, so this
// header includes no PyTorch header. Matrix products use the warp-level
// tensor-core instruction mma.sync.m16n8k16 with bf16 operands and f32
// accumulation: the same arithmetic contract as the TPU kernels' _dot
// (bf16 operands, f32 accumulate), on tiles small enough for N = 49 windows.
#pragma once

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (lower address)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// GELU and its derivative with erf by Abramowitz–Stegun 7.1.26, as
// _gelu_and_grad: 0.5·x·(1 + erf(x/√2)) and Φ(x) + x·exp(-x²/2)/√(2π),
// the erf polynomial's exp(-(x/√2)²) being the pdf's exp(-x²/2).
__device__ __forceinline__ float gelu_as(float x, float* grad = nullptr) {
  const float u = x * 0.7071067811865476f;
  const float au = fabsf(u);
  const float t = 1.f / (1.f + 0.3275911f * au);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = expf(-au * au);
  const float mag = 1.f - poly * e;
  const float erf = u > 0.f ? mag : (u < 0.f ? -mag : 0.f);
  if (grad != nullptr) *grad = 0.5f * (1.f + erf) + x * 0.3989422804014327f * e;
  return 0.5f * x * (1.f + erf);
}

// gelu_as without its gradient, by the fast intrinsics: the reciprocal by
// __fdividef and the exponential by __expf, both within a few f32 ulps of
// the exact operations over GELU's range, so the result differs from
// gelu_as's by a few f32 ulps, far below the bf16 rounding that follows it
// in the MLP's forward (mlp.cu, fc1). About a fifth fewer instructions.
__device__ __forceinline__ float gelu_as_fast(float x) {
  const float u = x * 0.7071067811865476f;
  const float au = fabsf(u);
  const float t = __fdividef(1.f, 1.f + 0.3275911f * au);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float mag = 1.f - poly * __expf(-au * au);
  return 0.5f * x * (1.f + copysignf(mag, u));
}

// D = A·B + D for one 16x8x16 tile. Fragment layout (PTX ISA, mma.m16n8k16,
// g = lane / 4, t = lane % 4): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..2t+1][g],
// b1 = B[2t+8..][g]; c0,c1 = D[g][2t], D[g][2t+1]; c2,c3 = D[g+8][2t..].
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += A(16 rows, KS) · B(8 rows j*8.., KS)ᵀ for j < NT, one warp.
// A and B are bf16 in shared memory with the reduction (k) dim contiguous:
// A row-major (row stride lda), B as the weight's (out, in) layout (row
// stride ldb). Rows of A at or beyond `arows` read as zero, so a 49-token
// window needs no zero-filled padding rows.
template <int NT, int KS>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const bf16* A, int lda, int arows,
                                         const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool lo = g < arows, hi = g + 8 < arows;
#pragma unroll 4
  for (int kk = 0; kk < KS; kk += 16) {
    uint32_t a[4];
    a[0] = lo ? ld32(A + g * lda + kk + 2 * t) : 0u;
    a[1] = hi ? ld32(A + (g + 8) * lda + kk + 2 * t) : 0u;
    a[2] = lo ? ld32(A + g * lda + kk + 2 * t + 8) : 0u;
    a[3] = hi ? ld32(A + (g + 8) * lda + kk + 2 * t + 8) : 0u;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* Bj = B + (j * 8 + g) * ldb + kk + 2 * t;
      mma_bf16_16816(acc[j], a, ld32(Bj), ld32(Bj + 8));
    }
  }
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// As warp_mma, with B stored k-major: element (k, n) at B[k·ldb + n] (a
// weight read along its output dim, e.g. dY·W for W in (out, in) layout).
template <int NT, int KS>
__device__ __forceinline__ void warp_mma_kn(float (&acc)[NT][4], const bf16* A, int lda,
                                            int arows, const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool lo = g < arows, hi = g + 8 < arows;
#pragma unroll 4
  for (int kk = 0; kk < KS; kk += 16) {
    uint32_t a[4];
    a[0] = lo ? ld32(A + g * lda + kk + 2 * t) : 0u;
    a[1] = hi ? ld32(A + (g + 8) * lda + kk + 2 * t) : 0u;
    a[2] = lo ? ld32(A + g * lda + kk + 2 * t + 8) : 0u;
    a[3] = hi ? ld32(A + (g + 8) * lda + kk + 2 * t + 8) : 0u;
    const bf16* B0 = B + (kk + 2 * t) * ldb + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* Bj = B0 + j * 8;
      mma_bf16_16816(acc[j], a, pack2(Bj[0], Bj[ldb]), pack2(Bj[8 * ldb], Bj[9 * ldb]));
    }
  }
}

// Copy `rows` rows of `cols` bf16 (cols % 8 == 0, 16-byte aligned rows)
// from global to shared memory with 16-byte accesses, all threads of the
// block. src_row(r) gives the global row pointer (column 0 of the slice),
// or nullptr for a row that reads as zeros.
template <typename RowFn>
__device__ __forceinline__ void copy_rows(bf16* dst, int ldd, int rows, int cols, RowFn src_row) {
  const int vec_per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, v = i - r * vec_per_row;
    const bf16* src = src_row(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) val = *reinterpret_cast<const uint4*>(src + v * 8);
    *reinterpret_cast<uint4*>(dst + r * ldd + v * 8) = val;
  }
}

// A (32 x C) f32 tile held as mma fragments by 8 warps laid out 2 (rows)
// x 4 (columns): warp (wm, wn) holds rows 16·wm.. and columns wn·C/4..,
// NT = C/32 tiles of 8 columns; lane (g, t) holds rows g and g + 8 and
// columns 2t, 2t + 1 of each tile.
//
// Each row's sum of the per-lane values v_lo (row 16·wm + g) and v_hi
// (row + 8), over the row's 4 lanes and 4 column warps, in a fixed order.
// `red` is 32·4 floats of shared scratch; all threads of the block call it.
__device__ __forceinline__ void tile_row_sums(float v_lo, float v_hi, float* red, float& s_lo,
                                              float& s_hi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wn = warp & 3, t = lane & 3;
  const int r_lo = (warp >> 2) * 16 + (lane >> 2), r_hi = r_lo + 8;
  v_lo += __shfl_xor_sync(0xffffffffu, v_lo, 1);
  v_lo += __shfl_xor_sync(0xffffffffu, v_lo, 2);
  v_hi += __shfl_xor_sync(0xffffffffu, v_hi, 1);
  v_hi += __shfl_xor_sync(0xffffffffu, v_hi, 2);
  __syncthreads();  // red may still be read by an earlier call
  if (t == 0) { red[r_lo * 4 + wn] = v_lo; red[r_hi * 4 + wn] = v_hi; }
  __syncthreads();
  s_lo = red[r_lo * 4] + red[r_lo * 4 + 1] + red[r_lo * 4 + 2] + red[r_lo * 4 + 3];
  s_hi = red[r_hi * 4] + red[r_hi * 4 + 1] + red[r_hi * 4 + 2] + red[r_hi * 4 + 3];
}

// LayerNorm statistics of the tile (two-pass mean/variance in f32, eps
// 1e-5, as _ln_fwd) after adding `bias`: acc becomes y − mean(y) per row,
// and inv_lo/inv_hi receive rsqrt(var + 1e-5) of the lane's two rows.
template <int NT>
__device__ __forceinline__ void ln_center(float (&acc)[NT][4], const float* __restrict__ bias,
                                          float* red, float& inv_lo, float& inv_hi) {
  constexpr int C = NT * 32;
  const int c0 = ((threadIdx.x >> 5) & 3) * (C / 4) + 2 * (threadIdx.x & 3);
  float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float b0 = bias[c0 + j * 8], b1 = bias[c0 + j * 8 + 1];
    acc[j][0] += b0; acc[j][1] += b1; acc[j][2] += b0; acc[j][3] += b1;
    s_lo += acc[j][0] + acc[j][1];
    s_hi += acc[j][2] + acc[j][3];
  }
  float mu_lo, mu_hi;
  tile_row_sums(s_lo, s_hi, red, mu_lo, mu_hi);
  mu_lo /= C;
  mu_hi /= C;
  float v_lo = 0.f, v_hi = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] -= mu_lo; acc[j][1] -= mu_lo; acc[j][2] -= mu_hi; acc[j][3] -= mu_hi;
    v_lo += acc[j][0] * acc[j][0] + acc[j][1] * acc[j][1];
    v_hi += acc[j][2] * acc[j][2] + acc[j][3] * acc[j][3];
  }
  tile_row_sums(v_lo, v_hi, red, v_lo, v_hi);
  inv_lo = rsqrtf(v_lo / C + 1e-5f);
  inv_hi = rsqrtf(v_hi / C + 1e-5f);
}

// Where the attention kernels find the (window w, head h) tile of a layout:
// row i at element w·win + h·head + i·row from its base pointer.
struct HeadTiles {
  long long win, head, row;
  __device__ size_t at(int w, int h, int i) const {
    return (size_t)w * win + (size_t)h * head + (size_t)i * row;
  }
};

// Cosine attention for one (window, head) on f32 operands in shared memory,
// the math of packed_heads_forward (hvt/ops/window_attention_pallas.py):
//   q̂ = q·rsqrt(Σq² + 1e-24), k̂ likewise,
//   P = softmax(scale·q̂k̂ᵀ + z), out = P·v.
// Q, K, V: N rows, row stride ld (odd, so column walks avoid bank
// conflicts); Q and K are normalized in place. S: N x (N+1) scratch. z: the
// (N, N) f32 bias(+mask) slice of this window and head. All threads of the
// block take part; out(i, c, value) receives each output element. With
// round_p, P is rounded to bf16 before P·v (hvt's split-q/k/v kernel rounds
// it to v's dtype, `attn.astype(v.dtype)`); the packed kernels keep it f32.
template <typename OutFn>
__device__ __forceinline__ void cosine_attention(float* Q, float* K, const float* V, int ld,
                                                 float* S, int N, int D, float scale,
                                                 const float* __restrict__ z, OutFn out,
                                                 bool round_p = false) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < 2 * N; r += nwarps) {
    float* v = r < N ? Q + r * ld : K + (r - N) * ld;
    float ss = 0.f;
    for (int c = lane; c < D; c += 32) ss += v[c] * v[c];
    const float inv = rsqrtf(warp_sum(ss) + 1e-24f);
    for (int c = lane; c < D; c += 32) v[c] *= inv;
  }
  __syncthreads();
  const int ldS = N + 1;
  for (int e = tid; e < N * N; e += blockDim.x) {
    const int i = e / N, j = e - i * N;
    const float* q = Q + i * ld;
    const float* k = K + j * ld;
    float dot = 0.f;
    for (int c = 0; c < D; ++c) dot += q[c] * k[c];
    S[i * ldS + j] = dot * scale + z[e];
  }
  __syncthreads();
  for (int i = warp; i < N; i += nwarps) {
    float* s = S + i * ldS;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, s[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(s[j] - m);
      s[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < N; j += 32) s[j] = round_p ? round_bf16(s[j] * inv) : s[j] * inv;
  }
  __syncthreads();
  for (int e = tid; e < N * D; e += blockDim.x) {
    const int i = e / D, c = e - i * D;
    const float* p = S + i * ldS;
    float o = 0.f;
    for (int j = 0; j < N; ++j) o += p[j] * V[j * ld + c];
    out(i, c, o);
  }
}

// The attention core's forward, one block per (window, head): the head's
// q, k, v tiles gathered through their layout's strides into shared memory,
// then cosine_attention. window_attention.cu launches it on packed and split
// layouts in bf16 and f32, swin_block.cu on its f32 qkv scratch.
template <typename T>
__global__ void __launch_bounds__(128)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     HeadTiles in, const float* __restrict__ scale, const float* __restrict__ z,
                     int nwz, T* __restrict__ out, HeadTiles ot, int n, int d, int heads,
                     bool round_p) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* Q = smem;
  float* K = Q + n * ld;
  float* V = K + n * ld;
  float* S = V + n * ld;
  const int w = blockIdx.x, h = blockIdx.y;
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int i = e / d, j = e - i * d;
    const size_t off = in.at(w, h, i) + j;
    Q[i * ld + j] = to_f32(q[off]);
    K[i * ld + j] = to_f32(k[off]);
    V[i * ld + j] = to_f32(v[off]);
  }
  __syncthreads();
  // window id = row mod nW (batch-major rows), as the TPU kernels' z index maps
  const float* zh = z + ((size_t)(w % nwz) * heads + h) * n * n;
  cosine_attention(
      Q, K, V, ld, S, n, d, scale[h], zh,
      [&](int i, int j, float o) { out[ot.at(w, h, i) + j] = from_f32<T>(o); }, round_p);
}

template <typename T>
int launch_attention(const void* q, const void* k, const void* v, HeadTiles in,
                     const float* scale, const float* z, int nwz, void* out, HeadTiles ot,
                     int nwb, int n, int d, int heads, bool round_p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * n * (d + 1) + n * (n + 1));
  auto kernel = attention_fwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(nwb, heads), 128, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), in, scale, z,
      nwz, static_cast<T*>(out), ot, n, d, heads, round_p);
  return (int)cudaGetLastError();
}

// out[i] = Σ_p part[p·count + i], i < count: 8 groups of parts, each summed
// in order, then the groups in order — the same bits on every run.
__global__ void __launch_bounds__(256)
sum_parts_kernel(const float* __restrict__ part, int parts, long long count,
                 float* __restrict__ out) {
  __shared__ float red[8][33];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < count)
    for (int p = grp; p < parts; p += 8) s += part[p * count + i];
  red[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && i < count) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) total += red[k][lane];
    out[i] = total;
  }
}

// out[i] = Σ_p part[p·count + i] in order p = 0, 1, ..., four outputs a
// thread (count4 = count / 4): for many outputs over few parts, where
// sum_parts_kernel's 32 outputs a block would launch blocks by the hundred
// thousand.
__global__ void __launch_bounds__(256)
sum_parts_wide_kernel(const float4* __restrict__ part, int parts, long long count4,
                      float4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= count4) return;
  float4 s = part[i];
  for (int p = 1; p < parts; ++p) {
    const float4 t = part[p * count4 + i];
    s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
  }
  out[i] = s;
}

// The partials summed in a fixed order (the same bits on every run): four
// outputs a thread where there are enough of them to fill the card and
// their vectors are 16-byte aligned, else 32 a block with the parts spread
// over its 8 warps.
inline int sum_parts(const float* part, int parts, long long count, float* out, cudaStream_t st) {
  const bool wide = count >= (1 << 18) && count % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(part) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (wide)
    sum_parts_wide_kernel<<<(unsigned)((count / 4 + 255) / 256), 256, 0, st>>>(
        reinterpret_cast<const float4*>(part), parts, count / 4, reinterpret_cast<float4*>(out));
  else
    sum_parts_kernel<<<(unsigned)((count + 31) / 32), 256, 0, st>>>(part, parts, count, out);
  return (int)cudaGetLastError();
}

}  // namespace hvt

// Message for a status returned by a launcher (each library is loaded on its
// own through ctypes, so each carries its own copy).
extern "C" const char* hvt_error_string(int err) {
  return err < 0 ? "unsupported shape" : cudaGetErrorString(static_cast<cudaError_t>(err));
}
