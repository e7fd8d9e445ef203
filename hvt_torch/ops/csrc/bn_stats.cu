// bn_stats: training-mode BatchNorm over the (rows, C) view of an NHWC
// activation, in four calls: two reductions, each a launch over the rows and
// a launch that finishes its sums, and the two elementwise passes that use
// what they finish.
//
//   hvt_bn_channel_sums: (Σx, Σx², mean, var, rstd) of each channel
//   hvt_bn_normalize:    y = ((x − mean)·rstd)·γ + β, rounded once to y's dtype
//   hvt_bn_bwd_reduce:   (Σg, Σg·x̂, γ·rstd, Σg/n, Σg·x̂/n) of each channel,
//                        x̂ = (x − mean)·rstd
//   hvt_bn_dx:           dx = γ·rstd·((g − Σg/n) − x̂·Σg·x̂/n), in x's dtype
//   hvt_bn_finish:       a reduction's finish alone, on chunk partials formed
//                        elsewhere (data parallelism: the rows launch of
//                        hvt_bn_channel_sums or hvt_bn_bwd_reduce with a
//                        null out, an all-reduce of its partials over the
//                        ranks, then this on the global n)
//
// Replaces: hvt/ops/bn_stats_pallas.py `_sums_pallas` (the pallas_call at
// line 94, body `_sums_kernel`) and `_bwd_reduce_pallas` (the pallas_call at
// line 181, body `_bwd_reduce_kernel`); the finishes and the two passes are
// the rest of `_bn_train_fwd` and `_bn_train_bwd` (:273-301), which XLA
// fuses around the TPU kernels. The per-channel formulas and the order of
// every elementwise operation are hvt's: each is a separately rounded f32
// operation (no contraction into fma), so the passes give the plain torch
// versions' bits on the same per-channel vectors, and the finish differs
// from the plain path only in the order of the sums.
//
// What bounds them on the H100: the bytes. Each reads its inputs once and
// writes its outputs once, at 2-6 operations per element, far below the
// card's balance point. ResNet-50's 53 BatchNorm inputs at batch 256 and 224
// px hold 2.845 G elements; in bf16 a training step moves 2 + 4 + 4 + 6 = 16
// B an element, 45.5 GB: the sums 1.70 ms at 3.35 TB/s, the normalize 3.40,
// the reduce 3.40 and dx 5.10. At the narrow maps (7×7, 3×3 and 4×4 at 88-112
// px) a call moves 2-50 MB, a few µs: there the fixed costs of a call, the
// launch and the host's, are what a design can save.
//
// Design (two launches a reduction, no value atomics, no serial tail):
//   1. the reduction: each block takes one chunk of rows and one tile of
//      channels, 256 threads laid out TX (channels, 8 per thread: one
//      16-byte load of bf16 a row; up to 32, 256 channels a tile) by
//      TY = 256 / TX (rows); each thread strides over its chunk's rows TY
//      apart with four rows' loads in flight and keeps f32 partials in
//      registers; a tree of fixed order in shared memory adds the TY
//      threads of each channel group, and the block writes its (2, C-tile)
//      partial to the scratch. About one wave of blocks: three an SM
//      (78-80 registers), 396 on the H100, so no partial last wave;
//   2. the finish, a second launch spread over the card: one block a group
//      of 8 channels, its 256 threads taking the chunks' partials 256
//      apart (at most two each), a butterfly of shuffles in each warp and
//      the eight warps' sums in order, then hvt's per-channel formulas:
//      mean, var and rstd forward; γ·rstd, Σg/n and Σg·x̂/n backward.
// The order of every sum is fixed by the indices alone: the same inputs
// give the same bits on every run. The parent's sum_parts added up to 132
// partials in sequence a thread, on 4 blocks at C = 64, and left the
// formulas to about six eager launches.
// Measured on the H100 and not kept (each variant in its own library, device
// time from torch.profiler): the finish inside the one launch, by
// thread-block clusters of 8 chunks combining their partials through
// distributed shared memory and a ticket counter electing each tile's last
// block, took 4-28 µs a call more than these two launches at ResNet-50's
// shapes; the cluster barriers alone slowed the rows' loop by 2-24 µs, and
// the last block's read of every cluster's partial is a tail on one SM.
// 64-channel tiles (TX = 8) took 22-28% longer than these 256-channel ones
// at C = 1024 and 2048.
// The scratch belongs to the wrapper: one workspace per (device, stream),
// so the two launches of a call and the calls that share it run in stream
// order (bn_stats_cuda._workspace). The kernels allocate nothing.
// The passes keep each thread's 8 channels' factors in registers (4 vectors
// forward, 5 backward) and stream rows with 16-byte loads and stores, on
// the same plan. bn_bwd_reduce and dx recompute x̂ from x, mean and rstd,
// as the TPU kernel and hvt's backward do. The TPU's fold of rows into
// lanes for C < 128 and its 1 MB row blocks are tiling of that machine and
// have no counterpart here.
#include "common.cuh"

namespace hvt {

constexpr int kBnThreads = 256;
constexpr int kBnUnroll = 4;   // rows whose loads a thread keeps in flight
constexpr int kBnFinish = 256;  // threads of a finish block (8 warps)

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

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16x2(v[0], v[1]);
  u.y = pack_bf16x2(v[2], v[3]);
  u.z = pack_bf16x2(v[4], v[5]);
  u.w = pack_bf16x2(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Thread layout of a block: TX threads across channel groups, TY across rows;
// the block's rows [r0, r1) of its chunk.
struct Lane {
  int tx, ty, TY, c0;
  long long r0, r1;
  bool active;  // a real channel group of a real row lane
  __device__ Lane(int TX, int C, long long M, long long rpc) {
    TY = kBnThreads / TX;
    tx = threadIdx.x % TX;
    ty = threadIdx.x / TX;
    c0 = (blockIdx.x * TX + tx) * 8;
    active = ty < TY && c0 < C;
    r0 = blockIdx.y * rpc;
    r1 = r0 + rpc < M ? r0 + rpc : M;
  }
};

// Walks the thread's rows of its chunk (r0 + ty, TY apart), four rows' loads
// in flight: body(u, row offset) for each row, with loads(u, offset) issued
// first for the kBnUnroll rows of a step.
template <typename Loads, typename Body>
__device__ __forceinline__ void walk_rows(const Lane& ln, int C, Loads loads, Body body) {
  const long long stride = (long long)ln.TY * C;
  long long r = ln.r0 + ln.ty;
  long long off = r * C + ln.c0;
  for (; r + (kBnUnroll - 1) * ln.TY < ln.r1; r += kBnUnroll * ln.TY) {
#pragma unroll
    for (int u = 0; u < kBnUnroll; ++u) loads(u, off + u * stride);
#pragma unroll
    for (int u = 0; u < kBnUnroll; ++u) body(u, off + u * stride);
    off += kBnUnroll * stride;
  }
  for (; r < ln.r1; r += ln.TY, off += stride) {
    loads(0, off);
    body(0, off);
  }
}

// Adds the 8-channel vectors (a, b) of the TY threads of each channel group
// in a tree of fixed order, and the row-0 thread writes the block's partial:
// part[chunk] = (2, C), a in row 0 and b in row 1 of its 8 channels.
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
    float* dst = part + 2LL * blockIdx.y * C + ln.c0;
    reinterpret_cast<float4*>(dst)[0] = red[slot][0];
    reinterpret_cast<float4*>(dst)[1] = red[slot][1];
    reinterpret_cast<float4*>(dst + C)[0] = red[slot][2];
    reinterpret_cast<float4*>(dst + C)[1] = red[slot][3];
  }
}

// The second launch of a reduction: block b adds the `parts` chunk
// partials of channels 8b..8b+8 (thread t takes partials t, t + 256, ...;
// a butterfly of shuffles in each warp; the warps' sums in order) and its
// thread 0 writes out = (5, C):
//   KIND 0 (sums):  Σx, Σx², mean = Σx/n, var = max(Σx²/n − mean², 0),
//                   rstd = rsqrt(var + eps);
//   KIND 1 (bwd):   Σg, Σg·x̂, γ·rstd (rstd where scale is null), Σg/n, Σg·x̂/n.
template <int KIND>
__global__ void __launch_bounds__(kBnFinish)
finish_kernel(const float* __restrict__ part, int parts, int C, float n, float eps,
              const float* __restrict__ rstd, const float* __restrict__ scale,
              float* __restrict__ out) {
  __shared__ float warp_sums[kBnFinish / 32][16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * 8;
  float a[8], b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = b[k] = 0.f;
  for (int p = threadIdx.x; p < parts; p += kBnFinish) {
    float va[8], vb[8];
    load8(part + 2LL * p * C + c0, va);
    load8(part + (2LL * p + 1) * C + c0, vb);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] += va[k];
      b[k] += vb[k];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] += __shfl_xor_sync(0xffffffffu, a[k], o);
      b[k] += __shfl_xor_sync(0xffffffffu, b[k], o);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      warp_sums[warp][k] = a[k];
      warp_sums[warp][8 + k] = b[k];
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = warp_sums[0][k];
    b[k] = warp_sums[0][8 + k];
  }
  for (int w = 1; w < kBnFinish / 32; ++w) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      a[k] += warp_sums[w][k];
      b[k] += warp_sums[w][8 + k];
    }
  }
  float r2[8], r3[8], r4[8];
  if (KIND == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      r2[k] = __fdiv_rn(a[k], n);
      r3[k] = fmaxf(__fsub_rn(__fdiv_rn(b[k], n), __fmul_rn(r2[k], r2[k])), 0.f);
      r4[k] = rsqrtf(__fadd_rn(r3[k], eps));
    }
  } else {
    float r[8];
    load8(rstd + c0, r);
#pragma unroll
    for (int k = 0; k < 8; ++k) r2[k] = r[k];
    if (scale != nullptr) {
      float ga[8];
      load8(scale + c0, ga);
#pragma unroll
      for (int k = 0; k < 8; ++k) r2[k] = __fmul_rn(ga[k], r[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      r3[k] = __fdiv_rn(a[k], n);
      r4[k] = __fdiv_rn(b[k], n);
    }
  }
  store8(out + c0, a);
  store8(out + C + c0, b);
  store8(out + 2 * C + c0, r2);
  store8(out + 3 * C + c0, r3);
  store8(out + 4 * C + c0, r4);
}

// Σx and Σx² of the chunk's rows into part[chunk] = (2, C).
template <typename T>
__global__ void __launch_bounds__(kBnThreads)
channel_sums_kernel(const T* __restrict__ x, long long M, int C, int TX, long long rpc,
                    float* __restrict__ part) {
  const Lane ln(TX, C, M, rpc);
  float s[8], q[8], v[kBnUnroll][8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = q[k] = 0.f;
  if (ln.active)
    walk_rows(
        ln, C, [&](int u, long long off) { load8(x + off, v[u]); },
        [&](int u, long long) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            s[k] += v[u][k];
            q[k] = fmaf(v[u][k], v[u][k], q[k]);
          }
        });
  block_partial(s, q, ln, TX, C, part);
}

// Σg and Σg·(x − mean)·rstd of the chunk's rows into part[chunk] = (2, C).
template <typename T>
__global__ void __launch_bounds__(kBnThreads)
bwd_reduce_kernel(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ mean,
                  const float* __restrict__ rstd, long long M, int C, int TX, long long rpc,
                  float* __restrict__ part) {
  const Lane ln(TX, C, M, rpc);
  float sg[8], sgx[8], mu[8], rs[8], vg[kBnUnroll][8], vx[kBnUnroll][8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sg[k] = sgx[k] = 0.f;
  if (ln.active) {
    load8(mean + ln.c0, mu);
    load8(rstd + ln.c0, rs);
    walk_rows(
        ln, C,
        [&](int u, long long off) {
          load8(g + off, vg[u]);
          load8(x + off, vx[u]);
        },
        [&](int u, long long) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            sg[k] += vg[u][k];
            sgx[k] = fmaf(vg[u][k], (vx[u][k] - mu[k]) * rs[k], sgx[k]);
          }
        });
  }
  block_partial(sg, sgx, ln, TX, C, part);
}

// y = ((x − mean)·rstd)·γ + β in f32, rounded once to Tout.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kBnThreads)
normalize_kernel(const Tin* __restrict__ x, const float* __restrict__ mean,
                 const float* __restrict__ rstd, const float* __restrict__ scale,
                 const float* __restrict__ bias, Tout* __restrict__ y, long long M, int C, int TX,
                 long long rpc) {
  const Lane ln(TX, C, M, rpc);
  if (!ln.active) return;
  float mu[8], rs[8], ga[8], be[8], v[kBnUnroll][8];
  load8(mean + ln.c0, mu);
  load8(rstd + ln.c0, rs);
  load8(scale + ln.c0, ga);
  load8(bias + ln.c0, be);
  walk_rows(
      ln, C, [&](int u, long long off) { load8(x + off, v[u]); },
      [&](int u, long long off) {
        float o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o[k] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[u][k], mu[k]), rs[k]), ga[k]), be[k]);
        store8(y + off, o);
      });
}

// dx = k·((g − m1) − ((x − mean)·rstd)·m2) in f32, rounded once to T; k, m1,
// m2 are bwd_reduce_kernel's γ·rstd, Σg/n, Σg·x̂/n.
template <typename T>
__global__ void __launch_bounds__(kBnThreads)
dx_kernel(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ mean,
          const float* __restrict__ rstd, const float* __restrict__ kf,
          const float* __restrict__ m1f, const float* __restrict__ m2f, T* __restrict__ dx,
          long long M, int C, int TX, long long rpc) {
  const Lane ln(TX, C, M, rpc);
  if (!ln.active) return;
  float mu[8], rs[8], k8[8], m1[8], m2[8], vg[kBnUnroll][8], vx[kBnUnroll][8];
  load8(mean + ln.c0, mu);
  load8(rstd + ln.c0, rs);
  load8(kf + ln.c0, k8);
  load8(m1f + ln.c0, m1);
  load8(m2f + ln.c0, m2);
  walk_rows(
      ln, C,
      [&](int u, long long off) {
        load8(g + off, vg[u]);
        load8(x + off, vx[u]);
      },
      [&](int u, long long off) {
        float o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float xh_m2 = __fmul_rn(__fmul_rn(__fsub_rn(vx[u][k], mu[k]), rs[k]), m2[k]);
          o[k] = __fmul_rn(__fsub_rn(__fsub_rn(vg[u][k], m1[k]), xh_m2), k8[k]);
        }
        store8(dx + off, o);
      });
}

// A plan the kernels do not take: rows, channels (a multiple of 8), threads
// across (1-32), chunks within the grid's y.
bool bad_plan(long long m, int c, int tx, int chunks) {
  return m < 1 || c < 8 || c % 8 != 0 || tx < 1 || tx > 32 || chunks < 1 || chunks > 65535;
}

// Channel tiles along x, row chunks along y.
struct Grid {
  dim3 grid;
  long long rpc;
  Grid(long long m, int c, int tx, int chunks)
      : grid((c + 8 * tx - 1) / (8 * tx), chunks), rpc((m + chunks - 1) / chunks) {}
};

// The finish over the chunks' partials (the reduction's second launch).
template <int KIND>
int finish(const float* part, int chunks, long long m, int c, float eps, const float* rstd,
           const float* scale, float* out, cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<KIND><<<c / 8, kBnFinish, 0, st>>>(part, chunks, c, (float)m, eps, rstd, scale,
                                                   out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sums(const void* x, long long m, int c, int tx, int chunks, float eps, float* part,
                float* out, cudaStream_t st) {
  const Grid p(m, c, tx, chunks);
  channel_sums_kernel<T><<<p.grid, kBnThreads, 0, st>>>(static_cast<const T*>(x), m, c, tx, p.rpc,
                                                        part);
  if (out == nullptr) return (int)cudaGetLastError();  // the rows launch alone
  return finish<0>(part, chunks, m, c, eps, nullptr, nullptr, out, st);
}

template <typename T>
int launch_bwd(const void* g, const void* x, const float* mean, const float* rstd,
               const float* scale, long long m, int c, int tx, int chunks, float* part, float* out,
               cudaStream_t st) {
  const Grid p(m, c, tx, chunks);
  bwd_reduce_kernel<T><<<p.grid, kBnThreads, 0, st>>>(static_cast<const T*>(g),
                                                       static_cast<const T*>(x), mean, rstd, m, c,
                                                       tx, p.rpc, part);
  if (out == nullptr) return (int)cudaGetLastError();  // the rows launch alone
  return finish<1>(part, chunks, m, c, 0.f, rstd, scale, out, st);
}

template <typename Tin, typename Tout>
int launch_normalize(const void* x, const float* mean, const float* rstd, const float* scale,
                     const float* bias, void* y, long long m, int c, int tx, int chunks,
                     cudaStream_t st) {
  const Grid p(m, c, tx, chunks);
  normalize_kernel<Tin, Tout><<<p.grid, kBnThreads, 0, st>>>(
      static_cast<const Tin*>(x), mean, rstd, scale, bias, static_cast<Tout*>(y), m, c, tx, p.rpc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx(const void* g, const void* x, const float* mean, const float* rstd, const float* k,
              const float* m1, const float* m2, void* dx, long long m, int c, int tx, int chunks,
              cudaStream_t st) {
  const Grid p(m, c, tx, chunks);
  dx_kernel<T><<<p.grid, kBnThreads, 0, st>>>(static_cast<const T*>(g), static_cast<const T*>(x),
                                               mean, rstd, k, m1, m2, static_cast<T*>(dx), m, c,
                                               tx, p.rpc);
  return (int)cudaGetLastError();
}

}  // namespace hvt

// dtype codes: 0 bf16, 1 f32. Every (rows, C) operand is row-major and
// 16-byte aligned, every per-channel vector (C,) f32 and 16-byte aligned.
// part: (chunks, 2, C) f32 scratch. Each returns a cudaError_t, or -1 for a
// plan the kernels do not take.

// x: (m, c); out: (5, c) = (Σx, Σx², mean, var, rstd). Two launches: the
// sums, then their finish; with a null out, the sums' launch alone, which
// leaves the (chunks, 2, c) partials in part.
extern "C" int hvt_bn_channel_sums(const void* x, long long m, int c, int tx, int chunks, float eps,
                                   float* part, float* out, int dtype, void* stream) {
  if (hvt::bad_plan(m, c, tx, chunks)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return hvt::launch_sums<hvt::bf16>(x, m, c, tx, chunks, eps, part, out, s);
  return hvt::launch_sums<float>(x, m, c, tx, chunks, eps, part, out, s);
}

// The finish alone, on partials that another step formed (the data-parallel
// route: each rank's rows launch, hvt_bn_channel_sums or hvt_bn_bwd_reduce
// with a null out, then an all-reduce of its partials over the ranks):
// part = (parts, 2, c) f32 of (Σx, Σx²) for kind 0 or (Σg, Σg·x̂) for kind
// 1, n the global row count; out = (5, c) as those entries write it. One
// launch of the same finish_kernel<kind>: on one rank's partials it gives
// those entries' bits.
extern "C" int hvt_bn_finish(const float* part, int parts, long long n, int c, float eps,
                             const float* rstd, const float* scale, float* out, int kind,
                             void* stream) {
  if (hvt::bad_plan(n, c, 1, parts) || kind < 0 || kind > 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) return hvt::finish<0>(part, parts, n, c, eps, nullptr, nullptr, out, s);
  return hvt::finish<1>(part, parts, n, c, 0.f, rstd, scale, out, s);
}

// x: (m, c) of x_dtype; y: (m, c) of y_dtype.
extern "C" int hvt_bn_normalize(const void* x, const float* mean, const float* rstd,
                                const float* scale, const float* bias, void* y, long long m, int c,
                                int tx, int chunks, int x_dtype, int y_dtype, void* stream) {
  if (hvt::bad_plan(m, c, tx, chunks)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using hvt::bf16;
  if (x_dtype == 0 && y_dtype == 0)
    return hvt::launch_normalize<bf16, bf16>(x, mean, rstd, scale, bias, y, m, c, tx, chunks, s);
  if (x_dtype == 0)
    return hvt::launch_normalize<bf16, float>(x, mean, rstd, scale, bias, y, m, c, tx, chunks, s);
  if (y_dtype == 0)
    return hvt::launch_normalize<float, bf16>(x, mean, rstd, scale, bias, y, m, c, tx, chunks, s);
  return hvt::launch_normalize<float, float>(x, mean, rstd, scale, bias, y, m, c, tx, chunks, s);
}

// g, x: (m, c) of one dtype; scale may be null (γ = 1); out: (5, c) =
// (Σg, Σg·x̂, γ·rstd, Σg/n, Σg·x̂/n). Two launches: the sums, then their
// finish; with a null out, the sums' launch alone (partials in part).
extern "C" int hvt_bn_bwd_reduce(const void* g, const void* x, const float* mean,
                                 const float* rstd, const float* scale, long long m, int c, int tx,
                                 int chunks, float* part, float* out, int dtype, void* stream) {
  if (hvt::bad_plan(m, c, tx, chunks)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return hvt::launch_bwd<hvt::bf16>(g, x, mean, rstd, scale, m, c, tx, chunks, part, out, s);
  return hvt::launch_bwd<float>(g, x, mean, rstd, scale, m, c, tx, chunks, part, out, s);
}

// g, x, dx: (m, c) of one dtype; k, m1, m2: hvt_bn_bwd_reduce's γ·rstd,
// Σg/n and Σg·x̂/n.
extern "C" int hvt_bn_dx(const void* g, const void* x, const float* mean, const float* rstd,
                         const float* k, const float* m1, const float* m2, void* dx, long long m,
                         int c, int tx, int chunks, int dtype, void* stream) {
  if (hvt::bad_plan(m, c, tx, chunks)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return hvt::launch_dx<hvt::bf16>(g, x, mean, rstd, k, m1, m2, dx, m, c, tx, chunks, s);
  return hvt::launch_dx<float>(g, x, mean, rstd, k, m1, m2, dx, m, c, tx, chunks, s);
}
