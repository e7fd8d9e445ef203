// The retired mega-fused SwinV2 block halves, forward only, at f32 accuracy:
//
//   swin_block_attention_fwd: x (B, H, W, C) -> LN(proj(window attention(qkv(x)))) (B, H, W, C)
//   swin_block_mlp_fwd:       x (B, H, W, C) -> LN(fc2(gelu(fc1 x)))               (B, H, W, C)
//
// Replace: hvt/ops/swin_block_pallas.py `fused_attention_branch` (the
// pallas_call at line 160; body `_make_attn_kernel`) and `fused_mlp_branch`
// (the pallas_call at line 244; body `_make_mlp_kernel`).
//
// Their contract is not the fused halves' (fused_halves.cu): x and every
// weight are read as f32 and every product is f32-accurate, the cosine
// attention core and the LayerNorm (eps 1e-5) too; the MLP rounds gelu(fc1
// x + b1) to fc2's weight dtype before fc2 (the A&S erf polynomial, by
// __expf and __fdividef: within a few f32 ulps of the exact operations).
// No residual, no drop-path scale, no shift: the caller rolls the map and
// adds the branch. x comes in bf16 or f32, the weights all bf16 or all f32.
//
// Precision plan: every product runs on bf16 tensor cores with f32
// accumulation. A product of two bf16 values is exact in f32, so a product
// whose operands are both bf16 (qkv and fc1 on bf16 x and weights, fc2 on a
// bf16 W2) is one pass. An f32 operand enters as three bf16 pieces p0 + p1
// + p2 (p0 = bf16(v), p1 = bf16(v − p0), p2 = bf16(v − p0 − p1)), and the
// product sums the piece products of order at most 2, smallest first:
// (2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0) where both operands are
// f32, (2, 0), (1, 0), (0, 0) where only A is (piece_terms); the terms
// dropped are below 2^-24 of the product, f32's own rounding. Two pieces
// miss f32's 1e-4 at SwinV2-T's stage 1, where the logit scale (up to 100)
// multiplies q's and k's error (tests/test_torch_port_swin_block_tc_plan.py
// shows both). The attention
// core takes the f32 qkv through attention_fwd_tc.cuh's f32 path (the same
// three pieces, six products for q·kᵀ, P as bf16 hi + lo against v's).
//
// What bounds them on the H100, counted as the tensor cores run them: the
// operations. The attention branch does 8·T·C² + 4·T·N·C of them, the MLP
// 16·T·C² (hidden 4C), each product times its piece products; for 2·T·C
// values of x in and out. Over a SwinV2-T forward at batch 64 (Σ T·C² =
// 22.2e9, Σ T·N·C = 4.5e9): attention 1.15e12 operations in f32 (6 piece
// products for qkv and proj, 6 + 3 for the core), 1.16 ms at 989 TFLOP/s,
// 0.35 ms in bf16 (qkv 1, proj 3); MLP 2.13e12 in f32 (6 each), 2.16 ms,
// 0.36 ms in bf16 (1 each); x and out are 0.22 ms (f32) of bytes.
//
// Design: each branch is a chain of launches on the stream, with scratch in
// device memory between them, so that no tile grows with C:
//   attention: [x's pieces, the weights' pieces: sb_split_kernel] ->
//              qkv = x·Wqkvᵀ + b (sb_qkv_kernel: A's rows gathered in the
//              window-major order of _group_windows by the loader, f32 out)
//              -> the cosine core per (chunk of windows, window id, head)
//              (attention_fwd_tc_kernel<float> at head dim 32 and N <= 64,
//              attention_fwd_kernel on CUDA cores at other shapes) -> the
//              core's pieces (sb_split_kernel) -> proj (sb_proj_kernel, f32
//              out) -> LayerNorm, stored back to the map (_ungroup_windows)
//              in x's dtype (sb_layer_norm_kernel);
//   MLP:       [pieces] -> h = gelu(x·W1ᵀ + b1) stored in W2's dtype, or as
//              its three pieces for an f32 W2 (sb_fc1_kernel) -> h·W2ᵀ + b2
//              (sb_fc2_kernel, f32) -> LayerNorm in x's dtype.
// The four products run on gemm_wgmma.cuh's warpgroup ring
// (wg_gemm_slices): 128 x BN output tiles (BN 128, or 96 where 96 divides
// the columns and 128 does not), two blocks an SM, K in 64-wide swizzled
// slices by cp.async, the piece products one after another along K into one
// f32 accumulator. The TPU kernels keep one image per grid step in VMEM; a
// block of the H100 cannot (SwinV2-T's stage 1 is 1.2 MB of f32 x and 3.6
// MB of qkv per image, against 227 KB of shared memory).
#include <type_traits>

#include "attention_fwd_tc.cuh"
#include "gemm_wgmma.cuh"

namespace hvt {

// Where row r of a (T, ·) operand or result lies in memory: row r itself
// (window 0), or row r of the window-major token order of _group_windows
// over B images of h x w (window > 0), read from the NHWC map.
struct Rows {
  int h, w, window;
  __device__ long long src(long long r) const {
    if (window == 0) return r;
    const int n = window * window, nw = w / window, wins = (h / window) * nw;
    const long long win = r / n, img = win / wins;
    const int t = (int)(r - win * n), j = (int)(win - img * wins);
    const int row = (j / nw) * window + t / window, col = (j % nw) * window + t % window;
    return (img * h + row) * w + col;
  }
};

// ---------------------------------------------------------------------------
// The pieces of f32 operands
// ---------------------------------------------------------------------------

// p (3, n) = the three bf16 pieces of each of src's n f32 values (n a
// multiple of 4): v = p[i] + p[n + i] + p[2n + i] (split3_bf16x2), a float4
// a thread a step. Bound by bytes: 4 in, 6 out a value.
__global__ void __launch_bounds__(256)
sb_split_kernel(const float* __restrict__ src, bf16* __restrict__ p, long long n) {
  const long long step = 4LL * gridDim.x * blockDim.x;
  for (long long i = 4LL * ((long long)blockIdx.x * blockDim.x + threadIdx.x); i < n; i += step) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    uint32_t lo[3], hi[3];
    split3_bf16x2(v.x, v.y, lo);
    split3_bf16x2(v.z, v.w, hi);
#pragma unroll
    for (int part = 0; part < 3; ++part)
      *reinterpret_cast<uint2*>(p + part * n + i) = make_uint2(lo[part], hi[part]);
  }
}

inline int split3(const void* src, bf16* p, long long n, cudaStream_t st) {
  const long long blocks = (n / 4 + 255) / 256;
  sb_split_kernel<<<(int)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, st>>>(
      static_cast<const float*>(src), p, n);
  return (int)cudaGetLastError();
}

// The piece products of one product, in the order they are summed: term t
// multiplies piece (a >> 2t) & 3 of A by piece (b >> 2t) & 3 of B.
struct Terms {
  int n, a, b;
};

// The terms of order at most 2 of A in pa pieces and B in pb (1 or 3 each),
// smallest first: (2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0), the order
// in which attention_fwd_tc.cuh sums q·kᵀ's.
inline Terms piece_terms(int pa, int pb) {
  constexpr int kI[6] = {2, 0, 1, 1, 0, 0}, kJ[6] = {0, 2, 1, 0, 1, 0};
  Terms t{0, 0, 0};
  for (int e = 0; e < 6; ++e)
    if (kI[e] < pa && kJ[e] < pb) {
      t.a |= kI[e] << (2 * t.n);
      t.b |= kJ[e] << (2 * t.n);
      ++t.n;
    }
  return t;
}

// ---------------------------------------------------------------------------
// The four products on the warpgroup ring
// ---------------------------------------------------------------------------

// out (m, n) = Σ_terms A_i·B_jᵀ + bias. A (m, K) bf16, piece i at a +
// i·a_plane, row r at map.src(r); B (n, K) bf16 (a weight in nn.Linear's
// layout), piece j at b + j·b_plane. K a multiple of 8, rows 16-byte aligned.
struct Linear {
  const bf16* a;
  long long a_plane;
  Rows map;
  int m;
  const bf16* b;
  long long b_plane;
  int n, K;
  Terms terms;
  const float* bias;
  void* out;
};

enum Epilogue { kF32 = 0, kGeluBf16 = 1, kGeluPieces = 2 };

// Stores the block's kWgBM x BN tile of T (f32 or bf16) into out (row
// stride n; rows m0.. below m, columns n0.. below n, n a multiple of 8),
// each pair of neighbouring columns (c, c + 1) of the tile as pack(c, v0,
// v1), one word of two T: through the ring, free once every warpgroup has
// left wg_gemm_slices, into rows of BN + 8 values (a half-warp's writes fall
// in distinct banks), then out in whole 16-byte pieces of rows, neighbouring
// threads on neighbouring pieces (gemm_wgmma.cuh's wg_store_bf16 with a
// column mask). Stored as the fragments' scattered 4- and 8-byte pairs,
// fc1's three f32 pieces of h took 5.8 ms of a SwinV2-T forward on the
// H100, staged 3.7.
template <typename T, int BN, typename PackFn>
__device__ __forceinline__ void sb_store(const float (&acc)[BN / 2], PackFn pack,
                                         T* __restrict__ out, int m, int n, int m0, int n0) {
  using Pair = std::conditional_t<sizeof(T) == 4, float2, uint32_t>;
  constexpr int kLd = BN + 8, kPer = 16 / sizeof(T), kPieces = BN / kPer;
  static_assert(kWgBM * kLd * sizeof(T) <= kWgStages * (kWgBM + BN) * 128, "fits the ring");
  T* const tile = reinterpret_cast<T*>(wg_smem_base());
  __syncthreads();  // every warpgroup is done with the ring, or with the last tile
  wg_pairs<BN>(acc, 0, 0, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<Pair*>(tile + r * kLd + c) = pack(c, v0, v1);
  });
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kWgBM * kPieces / kWgThreads; ++it) {
    const int i = threadIdx.x + it * kWgThreads, r = i / kPieces, c = kPer * (i % kPieces);
    if (m0 + r < m && n0 + c < n)
      *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * n + n0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * kLd + c);
  }
}

// The block's kWgBM x BN tile of p (rows blockIdx.y·kWgBM.., columns
// blockIdx.x·BN..): term t's K slices follow term t − 1's through the ring
// into one f32 accumulator. The epilogue adds the bias and stores (sb_store):
// kF32 f32; kGeluBf16 the GELU of the sum in bf16; kGeluPieces its three
// bf16 pieces, piece i at out + i·m·n.
template <int BN, int kEpi>
__device__ __forceinline__ void sb_linear_tile(const Linear& p) {
  constexpr int kRows = kWgBM * 8 / kWgThreads;  // rows of A a thread copies, 16 bytes each
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * kWgBM, piece = threadIdx.x & 7;
  // this thread's rows of A (wg_load_slice's pieces), as offsets, -1 past m
  long long arow[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = m0 + (threadIdx.x >> 3) + i * (kWgThreads / 8);
    arow[i] = r < p.m ? p.map.src(r) * p.K : -1;
  }
  const int slices = (p.K + kWgBK - 1) / kWgBK;
  float acc[BN / 2];
  wg_gemm_slices<BN>(acc, p.terms.n * slices, [&](int s, unsigned char* d) {
    const int t = s / slices, k0 = (s - t * slices) * kWgBK, k = k0 + 8 * piece;
    const bf16* a = p.a + ((p.terms.a >> 2 * t) & 3) * p.a_plane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = (threadIdx.x >> 3) + i * (kWgThreads / 8);
      const bool ok = arow[i] >= 0 && k < p.K;
      cp_async16_zfill(d + r * 128 + ((piece ^ (r & 7)) << 4), ok ? a + arow[i] + k : a, ok);
    }
    wg_load_slice<BN>(d + kWgBM * 128, p.b + ((p.terms.b >> 2 * t) & 3) * p.b_plane, p.K, n0, p.n,
                      k0, p.K);
  });
  auto bias = [&](int c) { return n0 + c < p.n ? p.bias[n0 + c] : 0.f; };
  if constexpr (kEpi == kF32) {
    sb_store<float, BN>(
        acc, [&](int c, float v0, float v1) { return make_float2(v0 + bias(c), v1 + bias(c + 1)); },
        static_cast<float*>(p.out), p.m, p.n, m0, n0);
  } else {
    // gelu in place: value 4j + 2h + e of the thread sits at column 8j + 2·(lane mod 4) + e
    // of the tile (wg_pairs). gelu_as_fast: the same polynomial by __expf and
    // __fdividef, within a few f32 ulps of gelu_as, a fifth fewer
    // instructions in an epilogue that outweighs the products at C = 96-192.
    const int c0 = 2 * (threadIdx.x & 3);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      acc[i] = gelu_as_fast(acc[i] + bias(8 * (i / 4) + c0 + (i & 1)));
    bf16* const out = static_cast<bf16*>(p.out);
#pragma unroll
    for (int part = 0; part < (kEpi == kGeluBf16 ? 1 : 3); ++part)
      sb_store<bf16, BN>(
          acc,
          [&](int, float v0, float v1) {
            if constexpr (kEpi == kGeluBf16) {
              return pack_bf16x2(v0, v1);
            } else {
              uint32_t h[3];
              split3_bf16x2(v0, v1, h);
              return h[part];
            }
          },
          out + part * (size_t)p.m * p.n, p.m, p.n, m0, n0);
  }
}

// One name a product, so that a profile tells them apart.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 2)
sb_qkv_kernel(const __grid_constant__ Linear p) {
  sb_linear_tile<BN, kF32>(p);
}
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 2)
sb_proj_kernel(const __grid_constant__ Linear p) {
  sb_linear_tile<BN, kF32>(p);
}
template <int BN, int kEpi>
__global__ void __launch_bounds__(kWgThreads, 2)
sb_fc1_kernel(const __grid_constant__ Linear p) {
  sb_linear_tile<BN, kEpi>(p);
}
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 2)
sb_fc2_kernel(const __grid_constant__ Linear p) {
  sb_linear_tile<BN, kF32>(p);
}

// fn(std::integral_constant<int, BN>) for the output tile width of n
// columns: 96 where 96 divides n and 128 does not (C = 96 and 192, 3C =
// 288 and 576), else 128.
template <typename Fn>
int by_cols(int n, Fn fn) {
  if (n % 128 != 0 && n % 96 == 0) return fn(std::integral_constant<int, 96>{});
  return fn(std::integral_constant<int, 128>{});
}

template <int BN, typename Kernel>
int launch_linear(Kernel kernel, const Linear& p, cudaStream_t st) {
  if (int err = allow_smem(kernel, wg_smem<BN>())) return err;
  kernel<<<dim3((p.n + BN - 1) / BN, (p.m + kWgBM - 1) / kWgBM), kWgThreads, wg_smem<BN>(), st>>>(
      p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// LayerNorm rows
// ---------------------------------------------------------------------------

// LayerNorm of each f32 row r of pre (m, c) (two-pass mean and variance, eps
// 1e-5, as the TPU kernels), one warp a row, stored in TO to out's row
// map.src(r): the MLP's in place, the attention's back to the NHWC map
// (_ungroup_windows). ln_resid_fwd_kernel's pass (gemm_tc.cuh) without the
// residual: lane l keeps the columns l + 32v, v < c/32 <= kV, in registers,
// kV the smallest of 4, 8, 16 and 32 that holds c; wider rows (kV = 0) are
// read from memory in each pass. Bound by bytes: 4 + |TO| a value.
template <typename TO, int kV>
__global__ void __launch_bounds__(kLnThreads)
sb_layer_norm_kernel(const float* __restrict__ pre, Rows map, const float* __restrict__ lns,
                     const float* __restrict__ lnb, TO* __restrict__ out, int m, int c) {
  const int lane = threadIdx.x & 31, nv = c / 32;
  const long long r = (long long)blockIdx.x * (kLnThreads / 32) + (threadIdx.x >> 5);
  if (r >= m) return;  // the whole warp
  const float* y = pre + r * c + lane;
  TO* o = out + map.src(r) * c + lane;
  if constexpr (kV == 0) {
    float sum = 0.f;
    for (int v = 0; v < nv; ++v) sum += y[32 * v];
    const float mu = warp_sum(sum) / c;
    float var = 0.f;
    for (int v = 0; v < nv; ++v) {
      const float dv = y[32 * v] - mu;
      var += dv * dv;
    }
    const float inv = rsqrtf(warp_sum(var) / c + 1e-5f);
    for (int v = 0; v < nv; ++v)
      o[32 * v] = from_f32<TO>((y[32 * v] - mu) * inv * lns[32 * v + lane] + lnb[32 * v + lane]);
  } else {
    float p[kV];
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (v < nv) {
        p[v] = y[32 * v];
        sum += p[v];
      }
    const float mu = warp_sum(sum) / c;
    float var = 0.f;
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (v < nv) {
        p[v] -= mu;
        var += p[v] * p[v];
      }
    const float inv = rsqrtf(warp_sum(var) / c + 1e-5f);
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (v < nv) o[32 * v] = from_f32<TO>(p[v] * inv * lns[32 * v + lane] + lnb[32 * v + lane]);
  }
}

template <typename TO>
int layer_norm(const float* pre, Rows map, const float* lns, const float* lnb, void* out, int m,
               int c, cudaStream_t st) {
  auto kernel = c <= 128    ? sb_layer_norm_kernel<TO, 4>
                : c <= 256  ? sb_layer_norm_kernel<TO, 8>
                : c <= 512  ? sb_layer_norm_kernel<TO, 16>
                : c <= 1024 ? sb_layer_norm_kernel<TO, kMaxV>
                            : sb_layer_norm_kernel<TO, 0>;
  constexpr int rows = kLnThreads / 32;
  kernel<<<(m + rows - 1) / rows, kLnThreads, 0, st>>>(pre, map, lns, lnb, static_cast<TO*>(out),
                                                        m, c);
  return (int)cudaGetLastError();
}

inline int layer_norm_as(int dtype, const float* pre, Rows map, const float* lns,
                         const float* lnb, void* out, int m, int c, cudaStream_t st) {
  return dtype == 0 ? layer_norm<bf16>(pre, map, lns, lnb, out, m, c, st)
                    : layer_norm<float>(pre, map, lns, lnb, out, m, c, st);
}

// ---------------------------------------------------------------------------
// The two branches
// ---------------------------------------------------------------------------

inline int pieces_of(int dtype) { return dtype == 1 ? 3 : 1; }

int attention_branch(const void* x, const void* wqkv, const float* bqkv, const float* scale,
                     const float* z, int nwz, const void* wproj, const float* bproj,
                     const float* lns, const float* lnb, float* qkv, float* attn, bf16* pieces,
                     bf16* w_pieces, void* out, int b, int h, int w, int c, int heads, int window,
                     int per_block, int chunks, int x_dtype, int w_dtype, cudaStream_t st) {
  const int t = b * h * w, n = window * window, d = c / heads;
  const long long tc = (long long)t * c, cc = (long long)c * c;
  const Rows windows{h, w, window}, flat{0, 0, 0};
  const int px = pieces_of(x_dtype), pw = pieces_of(w_dtype);
  const bf16* xa = static_cast<const bf16*>(x);
  const bf16 *wq = static_cast<const bf16*>(wqkv), *wp = static_cast<const bf16*>(wproj);
  int err = 0;
  if (px == 3) {
    if ((err = split3(x, pieces, tc, st))) return err;
    xa = pieces;
  }
  if (pw == 3) {
    if ((err = split3(wqkv, w_pieces, 3 * cc, st))) return err;
    if ((err = split3(wproj, w_pieces + 9 * cc, cc, st))) return err;
    wq = w_pieces;
    wp = w_pieces + 9 * cc;
  }
  const Linear qkv_p{xa, tc, windows, t, wq, 3 * cc, 3 * c, c, piece_terms(px, pw), bqkv, qkv};
  err = by_cols(3 * c, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    return launch_linear<BN>(sb_qkv_kernel<BN>, qkv_p, st);
  });
  if (err) return err;
  const HeadTiles in{(long long)n * 3 * c, d, 3 * c}, ot{(long long)n * c, d, c};
  err = tc_forward_takes(n, d)
            ? launch_attention_fwd_tc<float, false>(qkv, qkv + c, qkv + 2 * c, in, scale, z, nwz,
                                                    attn, ot, t / n, n, heads, per_block, chunks,
                                                    st)
            : launch_attention<float>(qkv, qkv + c, qkv + 2 * c, in, scale, z, nwz, attn, ot,
                                      t / n, n, d, heads, false, st);
  if (err) return err;
  // the core's pieces over x's, which qkv has read by then (stream order)
  if ((err = split3(attn, pieces, tc, st))) return err;
  // proj into qkv's first T·C floats, which the core has read by then
  const Linear proj_p{pieces, tc, flat, t, wp, cc, c, c, piece_terms(3, pw), bproj, qkv};
  err = by_cols(c, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    return launch_linear<BN>(sb_proj_kernel<BN>, proj_p, st);
  });
  if (err) return err;
  return layer_norm_as(x_dtype, qkv, windows, lns, lnb, out, t, c, st);
}

int mlp_branch(const void* x, const void* w1, const float* b1, const void* w2, const float* b2,
               const float* lns, const float* lnb, bf16* x_pieces, bf16* w_pieces, void* hidden,
               float* pre, void* out, int t, int c, int hid, int x_dtype, int w_dtype,
               cudaStream_t st) {
  const long long tc = (long long)t * c, th = (long long)t * hid, ch = (long long)c * hid;
  const Rows flat{0, 0, 0};
  const int px = pieces_of(x_dtype), pw = pieces_of(w_dtype);
  const bf16* xa = static_cast<const bf16*>(x);
  const bf16 *w1a = static_cast<const bf16*>(w1), *w2a = static_cast<const bf16*>(w2);
  int err = 0;
  if (px == 3) {
    if ((err = split3(x, x_pieces, tc, st))) return err;
    xa = x_pieces;
  }
  if (pw == 3) {
    if ((err = split3(w1, w_pieces, ch, st))) return err;
    if ((err = split3(w2, w_pieces + 3 * ch, ch, st))) return err;
    w1a = w_pieces;
    w2a = w_pieces + 3 * ch;
  }
  // h in W2's dtype: bf16, or the three pieces of the f32 GELU output
  const Linear fc1_p{xa, tc, flat, t, w1a, ch, hid, c, piece_terms(px, pw), b1, hidden};
  err = by_cols(hid, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    return pw == 3 ? launch_linear<BN>(sb_fc1_kernel<BN, kGeluPieces>, fc1_p, st)
                   : launch_linear<BN>(sb_fc1_kernel<BN, kGeluBf16>, fc1_p, st);
  });
  if (err) return err;
  const Linear fc2_p{static_cast<const bf16*>(hidden), th, flat, t, w2a, ch, c, hid,
                     piece_terms(pw, pw), b2, pre};
  err = by_cols(c, [&](auto bn) {
    constexpr int BN = decltype(bn)::value;
    return launch_linear<BN>(sb_fc2_kernel<BN>, fc2_p, st);
  });
  if (err) return err;
  return layer_norm_as(x_dtype, pre, flat, lns, lnb, out, t, c, st);
}

inline bool dtypes_ok(int x_dtype, int w_dtype) {
  return (x_dtype == 0 || x_dtype == 1) && (w_dtype == 0 || w_dtype == 1);
}

}  // namespace hvt

// x, out (B, H, W, C) in x_dtype; wqkv (3C, C) and wproj (C, C) in w_dtype
// (0 = bf16, 1 = f32); bqkv (3C,), scale (heads,), z (nwz, heads, N, N) with
// nwz 1 or the windows of an image, bproj, lns and lnb (C,), all f32; rows
// 16-byte aligned. Scratch, T = B·H·W: qkv (T, 3C) and attn (T, C) f32,
// pieces (3, T, C) bf16, w_pieces (3, 4C, C) bf16 where w_dtype is 1 (else
// unread). per_block and chunks size the tensor-core core's grid
// (window_attention_cuda.tc_forward_chunks), which runs at head dim 32 and
// N <= 64. Returns a cudaError_t, or -1 for a shape the kernels do not take.
extern "C" int hvt_swin_block_attention_fwd(const void* x, const void* wqkv, const float* bqkv,
                                            const float* scale, const float* z, int nwz,
                                            const void* wproj, const float* bproj,
                                            const float* lns, const float* lnb, float* qkv,
                                            float* attn, hvt::bf16* pieces, hvt::bf16* w_pieces,
                                            void* out, int b, int h, int w, int c, int heads,
                                            int window, int per_block, int chunks, int x_dtype,
                                            int w_dtype, void* stream) {
  if (!hvt::dtypes_ok(x_dtype, w_dtype) || c <= 0 || c % 32 || heads <= 0 || c % heads ||
      window <= 0 || h % window || w % window || per_block < 1 || chunks < 1 ||
      (long long)b * h * w > 65535LL * hvt::kWgBM)
    return -1;
  const int n_win = (h / window) * (w / window);
  if (nwz != 1 && nwz != n_win) return -1;
  return hvt::attention_branch(x, wqkv, bqkv, scale, z, nwz, wproj, bproj, lns, lnb, qkv, attn,
                               pieces, w_pieces, out, b, h, w, c, heads, window, per_block, chunks,
                               x_dtype, w_dtype, static_cast<cudaStream_t>(stream));
}

// x, out (T, C) in x_dtype (the flat NHWC map); w1 (hid, C) and w2 (C, hid)
// in w_dtype; b1 (hid,), b2, lns and lnb (C,) f32; rows 16-byte aligned.
// Scratch: x_pieces (3, T, C) bf16 where x_dtype is 1, w_pieces (3, hid, C)
// then (3, C, hid) bf16 where w_dtype is 1 (else unread); hidden (T, hid)
// bf16, or (3, T, hid) bf16 (the pieces of f32 h) where w_dtype is 1; pre
// (T, C) f32. Returns a cudaError_t, or -1 for a shape the kernels do not
// take.
extern "C" int hvt_swin_block_mlp_fwd(const void* x, const void* w1, const float* b1,
                                      const void* w2, const float* b2, const float* lns,
                                      const float* lnb, hvt::bf16* x_pieces, hvt::bf16* w_pieces,
                                      void* hidden, float* pre, void* out, int t, int c, int hid,
                                      int x_dtype, int w_dtype, void* stream) {
  if (!hvt::dtypes_ok(x_dtype, w_dtype) || t <= 0 || c <= 0 || c % 32 || hid <= 0 || hid % 32 ||
      (long long)t > 65535LL * hvt::kWgBM)
    return -1;
  return hvt::mlp_branch(x, w1, b1, w2, b2, lns, lnb, x_pieces, w_pieces, hidden, pre, out, t, c,
                         hid, x_dtype, w_dtype, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of a product's block at output tiles of bn columns
// (96 or 128), bytes; -1 for another width.
extern "C" int hvt_swin_block_smem(int bn) {
  return bn == 96 ? (int)hvt::wg_smem<96>() : bn == 128 ? (int)hvt::wg_smem<128>() : -1;
}
