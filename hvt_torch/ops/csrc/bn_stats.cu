// bn_stats: the two per-channel reductions of training-mode BatchNorm, over
// the (rows, C) view of an NHWC activation.
//
//   hvt_bn_channel_sums: (Σx, Σx²) of each channel
//   hvt_bn_bwd_reduce:   (Σg, Σg·x̂) of each channel, x̂ = (x − mean)·rstd
//
// Replaces: hvt/ops/bn_stats_pallas.py `_sums_pallas` (the pallas_call at
// line 94, body `_sums_kernel`) and `_bwd_reduce_pallas` (the pallas_call at
// line 181, body `_bwd_reduce_kernel`).
//
// What bounds them on the H100: the bytes. Each reads its inputs once and
// writes 2·C floats, at 2-4 operations per element read, far below the card's
// balance point. ResNet-50's 53 BatchNorm inputs at batch 256 and 224 px hold
// 2.845 G elements: a training step's channel_sums read 5.69 GB of bf16 (1.70
// ms at 3.35 TB/s) and its bn_bwd_reduce 11.38 GB (3.40 ms).
//
// Design: the TPU kernels walk the row blocks in order on one core and carry
// the sums in their output block; here blocks run in parallel and no order
// carries over. Each block takes one chunk of rows and one tile of channels:
// 256 threads laid out TX (channels, 8 per thread: one 16-byte load of bf16 a
// row) by TY = 256 / TX (rows). Each thread strides over its chunk's rows TY
// apart with four rows' loads in flight, and keeps f32 partial sums in
// registers. A tree of fixed order in shared memory adds the TY threads of a
// channel group, and the block writes its (2, C-tile) partial; a second
// launch (sum_parts, common.cuh) adds the chunks' partials in a fixed order.
// No atomics: the same inputs give the same bits on every run. The wrapper
// picks the chunk count for about 8 blocks per SM, so even the narrowest
// ResNet-50 input (12,544 rows x 2,048 channels) fills the 132 SMs.
// bn_bwd_reduce recomputes x̂ in registers from x, mean and rstd, as the TPU
// kernel does. The TPU's fold of rows into lanes for C < 128 and its 1 MB row
// blocks are tiling of that machine and have no counterpart here.
#include "common.cuh"

namespace hvt {

constexpr int kBnThreads = 256;
constexpr int kBnUnroll = 4;  // rows whose loads a thread keeps in flight

__device__ __forceinline__ void load8(const bf16* __restrict__ p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Thread layout of a block: TX threads across channel groups, TY across rows.
struct Lane {
  int tx, ty, TY, c0;
  bool active;  // a real channel group of a real row lane
  __device__ Lane(int TX, int C) {
    TY = kBnThreads / TX;
    tx = threadIdx.x % TX;
    ty = threadIdx.x / TX;
    c0 = (blockIdx.y * TX + tx) * 8;
    active = ty < TY && c0 < C;
  }
};

// Adds the 8-channel vectors (a, b) of the TY threads of each channel group
// in a tree of fixed order, and the row-0 thread writes the block's partial:
// part[c] = Σa, part[C + c] = Σb for its 8 channels.
__device__ __forceinline__ void block_partial(const float (&a)[8], const float (&b)[8],
                                              const Lane& ln, int TX, int C,
                                              float* __restrict__ part) {
  __shared__ float4 red[kBnThreads][4];
  const int slot = ln.ty * TX + ln.tx;
  if (ln.active) {
    red[slot][0] = make_float4(a[0], a[1], a[2], a[3]);
    red[slot][1] = make_float4(a[4], a[5], a[6], a[7]);
    red[slot][2] = make_float4(b[0], b[1], b[2], b[3]);
    red[slot][3] = make_float4(b[4], b[5], b[6], b[7]);
  }
  __syncthreads();
  int h = 1;
  while (h < ln.TY) h <<= 1;
  for (h >>= 1; h > 0; h >>= 1) {
    if (ln.active && ln.ty < h && ln.ty + h < ln.TY) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 o = red[slot + h * TX][i];
        float4& m = red[slot][i];
        m.x += o.x; m.y += o.y; m.z += o.z; m.w += o.w;
      }
    }
    __syncthreads();
  }
  if (ln.active && ln.ty == 0) {
    float4* pa = reinterpret_cast<float4*>(part + ln.c0);
    float4* pb = reinterpret_cast<float4*>(part + C + ln.c0);
    pa[0] = red[slot][0];
    pa[1] = red[slot][1];
    pb[0] = red[slot][2];
    pb[1] = red[slot][3];
  }
}

// Block (chunk, channel tile): Σx and Σx² of rows [chunk·rpc, (chunk+1)·rpc)
// into part[chunk] = (2, C).
template <typename T>
__global__ void __launch_bounds__(kBnThreads)
channel_sums_kernel(const T* __restrict__ x, long long M, int C, int TX, long long rpc,
                    float* __restrict__ part) {
  const Lane ln(TX, C);
  const long long r0 = blockIdx.x * rpc;
  const long long r1 = r0 + rpc < M ? r0 + rpc : M;
  float s[8], q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = q[k] = 0.f;
  if (ln.active) {
    const long long stride = (long long)ln.TY * C;
    const T* p = x + (r0 + ln.ty) * C + ln.c0;
    long long r = r0 + ln.ty;
    for (; r + (kBnUnroll - 1) * ln.TY < r1; r += kBnUnroll * ln.TY) {
      float v[kBnUnroll][8];
#pragma unroll
      for (int u = 0; u < kBnUnroll; ++u) load8(p + u * stride, v[u]);
      p += kBnUnroll * stride;
#pragma unroll
      for (int u = 0; u < kBnUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          s[k] += v[u][k];
          q[k] = fmaf(v[u][k], v[u][k], q[k]);
        }
      }
    }
    for (; r < r1; r += ln.TY, p += stride) {
      float v[8];
      load8(p, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        s[k] += v[k];
        q[k] = fmaf(v[k], v[k], q[k]);
      }
    }
  }
  block_partial(s, q, ln, TX, C, part + 2LL * blockIdx.x * C);
}

// Block (chunk, channel tile): Σg and Σg·(x − mean)·rstd of the chunk's rows.
template <typename T>
__global__ void __launch_bounds__(kBnThreads)
bwd_reduce_kernel(const T* __restrict__ g, const T* __restrict__ x,
                  const float* __restrict__ mean, const float* __restrict__ rstd, long long M,
                  int C, int TX, long long rpc, float* __restrict__ part) {
  const Lane ln(TX, C);
  const long long r0 = blockIdx.x * rpc;
  const long long r1 = r0 + rpc < M ? r0 + rpc : M;
  float sg[8], sgx[8], mu[8], rs[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sg[k] = sgx[k] = 0.f;
  if (ln.active) {
    load8(mean + ln.c0, mu);
    load8(rstd + ln.c0, rs);
    const long long stride = (long long)ln.TY * C;
    const long long off0 = (r0 + ln.ty) * C + ln.c0;
    const T* pg = g + off0;
    const T* px = x + off0;
    long long r = r0 + ln.ty;
    for (; r + (kBnUnroll - 1) * ln.TY < r1; r += kBnUnroll * ln.TY) {
      float vg[kBnUnroll][8], vx[kBnUnroll][8];
#pragma unroll
      for (int u = 0; u < kBnUnroll; ++u) {
        load8(pg + u * stride, vg[u]);
        load8(px + u * stride, vx[u]);
      }
      pg += kBnUnroll * stride;
      px += kBnUnroll * stride;
#pragma unroll
      for (int u = 0; u < kBnUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          sg[k] += vg[u][k];
          sgx[k] = fmaf(vg[u][k], (vx[u][k] - mu[k]) * rs[k], sgx[k]);
        }
      }
    }
    for (; r < r1; r += ln.TY, pg += stride, px += stride) {
      float vg[8], vx[8];
      load8(pg, vg);
      load8(px, vx);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sg[k] += vg[k];
        sgx[k] = fmaf(vg[k], (vx[k] - mu[k]) * rs[k], sgx[k]);
      }
    }
  }
  block_partial(sg, sgx, ln, TX, C, part + 2LL * blockIdx.x * C);
}

bool bad_shape(long long m, int c, int tx, int chunks) {
  return m < 1 || c < 8 || c % 8 != 0 || tx < 1 || tx > 32 || chunks < 1 ||
         chunks > (1 << 24);
}

int finish(float* part, int chunks, int c, float* out, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_parts(part, chunks, 2LL * c, out, st);
}

template <typename T>
int launch_sums(const void* x, long long m, int c, int tx, int chunks, float* part, float* out,
                cudaStream_t st) {
  const long long rpc = (m + chunks - 1) / chunks;
  const dim3 grid(chunks, (c + 8 * tx - 1) / (8 * tx));
  channel_sums_kernel<T><<<grid, kBnThreads, 0, st>>>(static_cast<const T*>(x), m, c, tx, rpc,
                                                       part);
  return finish(part, chunks, c, out, st);
}

template <typename T>
int launch_bwd(const void* g, const void* x, const float* mean, const float* rstd, long long m,
               int c, int tx, int chunks, float* part, float* out, cudaStream_t st) {
  const long long rpc = (m + chunks - 1) / chunks;
  const dim3 grid(chunks, (c + 8 * tx - 1) / (8 * tx));
  bwd_reduce_kernel<T><<<grid, kBnThreads, 0, st>>>(static_cast<const T*>(g),
                                                     static_cast<const T*>(x), mean, rstd, m, c,
                                                     tx, rpc, part);
  return finish(part, chunks, c, out, st);
}

}  // namespace hvt

// x: (m, c) row-major, bf16 (dtype 0) or f32 (dtype 1), 16-byte aligned;
// part: (chunks, 2, c) f32 scratch; out: (2, c) f32 = (Σx, Σx²). tx threads
// of a block span channels (8 each). Returns a cudaError_t, or -1 for a shape
// the kernel does not take.
extern "C" int hvt_bn_channel_sums(const void* x, long long m, int c, int tx, int chunks,
                                   float* part, float* out, int dtype, void* stream) {
  if (hvt::bad_shape(m, c, tx, chunks)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return hvt::launch_sums<hvt::bf16>(x, m, c, tx, chunks, part, out, s);
  return hvt::launch_sums<float>(x, m, c, tx, chunks, part, out, s);
}

// g, x: (m, c) row-major of one dtype as above; mean, rstd: (c,) f32;
// out: (2, c) f32 = (Σg, Σg·(x − mean)·rstd).
extern "C" int hvt_bn_bwd_reduce(const void* g, const void* x, const float* mean,
                                 const float* rstd, long long m, int c, int tx, int chunks,
                                 float* part, float* out, int dtype, void* stream) {
  if (hvt::bad_shape(m, c, tx, chunks)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return hvt::launch_bwd<hvt::bf16>(g, x, mean, rstd, m, c, tx, chunks, part, out, s);
  return hvt::launch_bwd<float>(g, x, mean, rstd, m, c, tx, chunks, part, out, s);
}
