// int8_conv: the int8 × int8 → int32 convolution of the w8a8 serving forward,
// with hvt's dequant epilogue, and that epilogue alone for torch._int_mm.
//
//   hvt_int8_conv:    NHWC int8 x, HWIO int8 w (KH, KW, C/groups, O), any
//                     groups, stride and (top, left) pads → NHWC out: the
//                     int32 sums, or f32(acc)·(sx·sw[o]) + b[o] in f32 or bf16
//   hvt_int8_dequant: that epilogue on the (m, ld) int32 product of
//                     torch._int_mm, the first n columns of each row → (m, n)
//
// Replaces no TPU kernel: hvt computes these in XLA (hvt/ops/quant.py
// `_quant_conv`, :136, lax.conv_general_dilated with an int32 result type, and
// `_quant_dense`'s dot_general, :184), outside any pallas_call. torch has no
// int8 convolution on CUDA, so the port writes one.
//
// The epilogue rounds as hvt does, twice: y = f32(acc) · (sx · sw[o]), then
// y + b[o], each a separately rounded f32 operation (__fmul_rn, __fadd_rn:
// nvcc does not contract them into an fma), then one rounding to bf16 (to
// nearest even). The int32 sums are exact, so the outputs equal the plain
// versions' (hvt_torch/ops/int8_cuda.py) bit for bit.
//
// What bounds it on the H100: a ResNet-50 3×3 conv at batch 64 does 14.8 G
// int8 operations (7.5 µs at 1,979 TOPS) and moves 7-39 MB (2-12 µs at
// 3.35 TB/s), so the early stages are bound by their bytes and the late
// ones by their operations; the depthwise convs (49 or fewer products a
// value) by their bytes. This first design is right and simple, and far
// from either bound:
//   * dense and grouped convs are an implicit GEMM on the CUDA cores'
//     dp4a (four int8 products a 32-bit instruction), not the tensor
//     cores: M = output pixels, N = a group's output channels, K = the
//     (kh, kw, c) taps. A block of 256 threads computes a 64 × 64 tile,
//     each thread 4 × 4 sums in registers, 32 taps a step: the input
//     gathered from the padded window (8 bytes a thread, one 8-byte load
//     where a group's channels are a multiple of 8 and x is 8-byte aligned,
//     else byte loads), the weights 8 bytes a thread, both stored K-minor in
//     shared memory (rows of 36 bytes: a warp's 16 columns hit 16 banks),
//     the next step's loads in flight during this step's products;
//   * depthwise convs (one channel a group) are one thread an output
//     value, channels fastest (coalesced), the KH·KW taps summed in int32.
// An int8 wgmma implicit GEMM (TMA gather or cp.async into the swizzle) is
// the redesign this kernel waits for (ROADMAP.md queue 2).
#include "common.cuh"

namespace hvt {

constexpr int kI8Threads = 256;
constexpr int kI8BM = 64;       // output pixels a block
constexpr int kI8BN = 64;       // output channels of one group a block
constexpr int kI8BK = 32;       // taps a step
constexpr int kI8Ld = kI8BK + 4;  // shared row stride in bytes

struct I8Conv {
  int n, h, w, c, kh, kw, o, groups, sh, sw, pt, pl, oh, ow;
  int cg, og, k;
  long long m;  // n · oh · ow
};

template <int OUT>
__device__ __forceinline__ void store_out(void* out, long long idx, int acc, float sx,
                                          const float* sw, const float* bias, int oc) {
  if (OUT == 0) {
    static_cast<int*>(out)[idx] = acc;
    return;
  }
  float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, sw[oc]));
  if (bias != nullptr) v = __fadd_rn(v, bias[oc]);
  if (OUT == 1)
    static_cast<float*>(out)[idx] = v;
  else
    static_cast<bf16*>(out)[idx] = __float2bfloat16_rn(v);
}

// VX: 8-byte loads of x (a group's channels a multiple of 8, x 8-byte aligned);
// VW: 8-byte loads of w (a group's output channels a multiple of 8, w aligned).
template <bool VX, bool VW, int OUT>
__global__ void __launch_bounds__(kI8Threads)
int8_conv_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ sx, const float* __restrict__ sw,
                      const float* __restrict__ bias, void* __restrict__ out, I8Conv s) {
  __shared__ __align__(16) int8_t sa[kI8BM * kI8Ld];
  __shared__ __align__(16) int8_t sb[kI8BN * kI8Ld];
  const int t = threadIdx.x;
  const int tiles_n = (s.og + kI8BN - 1) / kI8BN;
  const int g = blockIdx.y / tiles_n;
  const int n0 = (blockIdx.y % tiles_n) * kI8BN;
  const long long m0 = (long long)blockIdx.x * kI8BM;

  // the input loader: pixel row ar of the tile, taps ak..ak+7 of a step
  const int ar = t >> 2, ak = (t & 3) * 8;
  const long long am = m0 + ar;
  const bool arow = am < s.m;
  int ih0 = 0, iw0 = 0;
  long long img = 0;
  if (arow) {
    const int ox = (int)(am % s.ow);
    const long long r = am / s.ow;
    ih0 = (int)(r % s.oh) * s.sh - s.pt;
    iw0 = ox * s.sw - s.pl;
    img = r / s.oh;
  }
  const int8_t* xb = x + img * s.h * s.w * s.c + (long long)g * s.cg;
  // the weight loader: tap row bk of a step, output channels bn..bn+7 of the tile
  const int bk = t >> 3, bn = (t & 7) * 8;
  const int8_t* wb = w + (long long)g * s.og + n0 + bn;

  uint32_t ra0 = 0, ra1 = 0;
  uint8_t rbv[8];
  auto load_a = [&](int kt) {
    const int k = kt * kI8BK + ak;
    ra0 = ra1 = 0;
    if (!arow) return;
    if (VX) {
      if (k >= s.k) return;
      const int r = k / s.cg, ci = k - r * s.cg;
      const int ki = r / s.kw, kj = r - ki * s.kw;
      const int ih = ih0 + ki, iw = iw0 + kj;
      if (ih < 0 || ih >= s.h || iw < 0 || iw >= s.w) return;
      const uint2 v = *reinterpret_cast<const uint2*>(xb + ((long long)ih * s.w + iw) * s.c + ci);
      ra0 = v.x;
      ra1 = v.y;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int kk = k + e;
        if (kk >= s.k) break;
        const int r = kk / s.cg, ci = kk - r * s.cg;
        const int ki = r / s.kw, kj = r - ki * s.kw;
        const int ih = ih0 + ki, iw = iw0 + kj;
        if (ih < 0 || ih >= s.h || iw < 0 || iw >= s.w) continue;
        const uint32_t b = (uint8_t)xb[((long long)ih * s.w + iw) * s.c + ci];
        if (e < 4) ra0 |= b << (8 * e); else ra1 |= b << (8 * (e - 4));
      }
    }
  };
  auto load_b = [&](int kt) {
    const int kr = kt * kI8BK + bk;
#pragma unroll
    for (int e = 0; e < 8; ++e) rbv[e] = 0;
    if (kr >= s.k) return;
    const int8_t* row = wb + (long long)kr * s.o;
    if (VW) {
      if (n0 + bn >= s.og) return;
      const uint2 v = *reinterpret_cast<const uint2*>(row);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        rbv[e] = (uint8_t)(v.x >> (8 * e));
        rbv[e + 4] = (uint8_t)(v.y >> (8 * e));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (n0 + bn + e < s.og) rbv[e] = (uint8_t)row[e];
    }
  };

  const int tx = t & 15, ty = t >> 4;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  const int ktiles = (s.k + kI8BK - 1) / kI8BK;
  load_a(0);
  load_b(0);
  for (int kt = 0; kt < ktiles; ++kt) {
    uint32_t* pa = reinterpret_cast<uint32_t*>(sa + ar * kI8Ld + ak);
    pa[0] = ra0;
    pa[1] = ra1;
#pragma unroll
    for (int e = 0; e < 8; ++e) sb[(bn + e) * kI8Ld + bk] = (int8_t)rbv[e];
    __syncthreads();
    if (kt + 1 < ktiles) {  // the next step's loads fly during this step's products
      load_a(kt + 1);
      load_b(kt + 1);
    }
#pragma unroll
    for (int kk = 0; kk < kI8BK / 4; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const int*>(sa + (ty + 16 * i) * kI8Ld + 4 * kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const int*>(sb + (tx + 16 * j) * kI8Ld + 4 * kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float scale = OUT == 0 ? 0.f : *sx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= s.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx + 16 * j;
      if (nn >= s.og) continue;
      const int oc = g * s.og + nn;
      store_out<OUT>(out, m * s.o + oc, acc[i][j], scale, sw, bias, oc);
    }
  }
}

// Depthwise (C = O = groups): one thread an output value, channels fastest.
template <int OUT>
__global__ void __launch_bounds__(kI8Threads)
int8_conv_depthwise_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ sx, const float* __restrict__ sw,
                           const float* __restrict__ bias, void* __restrict__ out, I8Conv s) {
  const long long total = s.m * s.c;
  const float scale = OUT == 0 ? 0.f : *sx;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int ch = (int)(idx % s.c);
    const long long pix = idx / s.c;
    const int ox = (int)(pix % s.ow);
    const long long r = pix / s.ow;
    const int ih0 = (int)(r % s.oh) * s.sh - s.pt, iw0 = ox * s.sw - s.pl;
    const int8_t* xb = x + (r / s.oh) * s.h * s.w * s.c + ch;
    int acc = 0;
    for (int ki = 0; ki < s.kh; ++ki) {
      const int ih = ih0 + ki;
      if (ih < 0 || ih >= s.h) continue;
      for (int kj = 0; kj < s.kw; ++kj) {
        const int iw = iw0 + kj;
        if (iw < 0 || iw >= s.w) continue;
        acc += (int)xb[((long long)ih * s.w + iw) * s.c] * (int)w[(ki * s.kw + kj) * s.c + ch];
      }
    }
    store_out<OUT>(out, idx, acc, scale, sw, bias, ch);
  }
}

template <int OUT>
__global__ void __launch_bounds__(kI8Threads)
int8_dequant_kernel(const int* __restrict__ acc, const float* __restrict__ sx,
                    const float* __restrict__ sw, const float* __restrict__ bias,
                    void* __restrict__ out, long long count, int n, int ld) {
  const float scale = *sx;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < count;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / n;
    const int col = (int)(idx - row * n);
    store_out<OUT>(out, idx, acc[row * ld + col], scale, sw, bias, col);
  }
}

inline unsigned grid_for(long long total) {
  const long long blocks = (total + kI8Threads - 1) / kI8Threads;
  return (unsigned)(blocks < 132LL * 64 ? blocks : 132LL * 64);
}

template <int OUT>
int launch_conv(const int8_t* x, const int8_t* w, const float* sx, const float* sw,
                const float* bias, void* out, const I8Conv& s, bool vx, bool vw,
                cudaStream_t st) {
  if (s.cg == 1 && s.og == 1) {
    int8_conv_depthwise_kernel<OUT><<<grid_for(s.m * s.c), kI8Threads, 0, st>>>(
        x, w, sx, sw, bias, out, s);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((s.m + kI8BM - 1) / kI8BM),
                  (unsigned)(s.groups * ((s.og + kI8BN - 1) / kI8BN)));
  if (grid.y > 65535) return -1;
  if (vx && vw)
    int8_conv_gemm_kernel<true, true, OUT><<<grid, kI8Threads, 0, st>>>(x, w, sx, sw, bias, out, s);
  else if (vx)
    int8_conv_gemm_kernel<true, false, OUT><<<grid, kI8Threads, 0, st>>>(x, w, sx, sw, bias, out, s);
  else if (vw)
    int8_conv_gemm_kernel<false, true, OUT><<<grid, kI8Threads, 0, st>>>(x, w, sx, sw, bias, out, s);
  else
    int8_conv_gemm_kernel<false, false, OUT><<<grid, kI8Threads, 0, st>>>(x, w, sx, sw, bias, out, s);
  return (int)cudaGetLastError();
}

}  // namespace hvt

// x: (n, h, w, c) int8; w: (kh, kw, c / groups, o) int8; sx: one f32 (ignored
// for out_kind 0); sw: (o,) f32; bias: (o,) f32 or null; out: (n, oh, ow, o)
// of out_kind 0 int32, 1 f32, 2 bf16. x_mis, w_mis: the pointers' offsets
// from an 8-byte boundary. Returns a cudaError_t, or -1 for a shape the
// kernels do not take.
extern "C" int hvt_int8_conv(const int8_t* x, const int8_t* w, const float* sx, const float* sw,
                             const float* bias, void* out, int n, int h, int wd, int c, int kh,
                             int kw, int o, int groups, int sh, int sw_, int pt, int pl, int oh,
                             int ow, int out_kind, int x_mis, int w_mis, void* stream) {
  if (n < 1 || h < 1 || wd < 1 || c < 1 || kh < 1 || kw < 1 || o < 1 || groups < 1 ||
      c % groups || o % groups || sh < 1 || sw_ < 1 || oh < 1 || ow < 1 || out_kind < 0 ||
      out_kind > 2)
    return -1;
  hvt::I8Conv s{n, h, wd, c, kh, kw, o, groups, sh, sw_, pt, pl, oh, ow,
                c / groups, o / groups, kh * kw * (c / groups), (long long)n * oh * ow};
  const bool vx = x_mis == 0 && s.cg % 8 == 0;
  const bool vw = w_mis == 0 && s.og % 8 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_kind == 0) return hvt::launch_conv<0>(x, w, sx, sw, bias, out, s, vx, vw, st);
  if (out_kind == 1) return hvt::launch_conv<1>(x, w, sx, sw, bias, out, s, vx, vw, st);
  return hvt::launch_conv<2>(x, w, sx, sw, bias, out, s, vx, vw, st);
}

// acc: (m, ld) int32; out: the first n columns of each row, (m, n) of
// out_kind 0 int32, 1 f32, 2 bf16; count = m · n.
extern "C" int hvt_int8_dequant(const int* acc, const float* sx, const float* sw,
                                const float* bias, void* out, long long count, int n, int ld,
                                int out_kind, void* stream) {
  if (count < 1 || n < 1 || ld < n || out_kind < 0 || out_kind > 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = hvt::grid_for(count);
  if (out_kind == 0)
    hvt::int8_dequant_kernel<0><<<grid, hvt::kI8Threads, 0, st>>>(acc, sx, sw, bias, out, count, n, ld);
  else if (out_kind == 1)
    hvt::int8_dequant_kernel<1><<<grid, hvt::kI8Threads, 0, st>>>(acc, sx, sw, bias, out, count, n, ld);
  else
    hvt::int8_dequant_kernel<2><<<grid, hvt::kI8Threads, 0, st>>>(acc, sx, sw, bias, out, count, n, ld);
  return (int)cudaGetLastError();
}
