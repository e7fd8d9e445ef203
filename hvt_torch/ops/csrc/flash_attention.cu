// Flash attention over a whole sequence (ViT's and DINOv2's global attention,
// `use_flash`), forward and backward, for Hopper (sm_90a):
//
//   o = softmax(sm_scale · q·kᵀ) · v       per (image, head), keys < N only
//
// Replace: the TPU flash-attention op that hvt/models/vit.py `_attend_flash`
// (line 50) calls, jax/experimental/pallas/ops/tpu/flash_attention.py: the
// forward (the pallas_call at line 758), dK/dV (line 1121) and dQ (line
// 1456). Contract, as hvt calls it: s = q·kᵀ from bf16 operands summed in f32,
// times sm_scale; keys at or past the real N get no weight (hvt pads N to 128
// with segment ids; here the key loop masks instead, so there is no padded
// copy); an online softmax in f32; the unnormalised p rounded to v's dtype
// before p·v (flash_attention.py:471), summed in f32; o in q's dtype; the
// row log-sum-exp kept for the backward. The backward takes D = rowsum(dO∘O)
// in f32 from the caller, as jax computes it outside its kernels
// (flash_attention.py:274), recomputes P from the saved log-sum-exp, and
// rounds P and dS·sm_scale to bf16 before their products, as jax's
// kernels do (lines 900, 918, 1258): no N x N tensor reaches device memory.
// f32 inputs enter the tensor cores rounded to bf16 (the TPU's default
// precision for an f32 product) and o, dq, dk, dv come out in f32.
//
// Layout: q, k, v and dq, dk, dv share one set of strides (image, head, row;
// the head dim contiguous), o and dO another. The model passes views of its
// packed (B, N, 3·D) qkv projection and of its (B, N, D) attention output,
// so no head-split transpose reaches device memory. Rows must start on
// 16-byte boundaries. The log-sum-exp and D are (B·H, N) f32.
//
// What bounds it on the H100 at ViT-B/16's shapes (N = 197, head dim 64):
// the bytes. One forward reads q, k, v and writes o, 8·N·64 bytes an (image,
// head), and does 4·N²·64 FLOP: about 100 FLOP a byte, a third of the card's
// ~295 FLOP/byte balance point for bf16 tensor cores.
//
// Design (a simple right kernel first; wgmma/TMA are later work): blocks of
// four warps, blockIdx.x = image·H + head (so B·H may pass 65,535), blockIdx.y
// = a 64-row tile of queries (forward, dQ) or keys (dK/dV); each warp owns 16
// rows of the tile. The block loops over the other side's 64-row tiles,
// double-buffered in shared memory by cp.async (zero-filled past N; f32
// inputs rounded on the way in, synchronously), 128-byte rows with their
// 16-byte chunks XOR-swizzled by row for ldmatrix. Every product is
// mma.sync.m16n8k16 (bf16 operands, f32 accumulation). A row's softmax lives
// in one quad of a warp (max and sum are two shuffles), and P (or dS) feeds
// the next product as A fragments taken straight from the accumulators.
// Offsets are formed in 64 bits.
#include "attention_tc.cuh"

namespace hvt {
namespace flash {

constexpr int kD = 64;          // head dim
constexpr int kRows = 64;       // rows of a query or key tile
constexpr int kThreads = 128;   // four warps of 16 rows
constexpr int kTile = kRows * kD;  // bf16 elements of one tile (8 KB)

struct Layout {  // strides in elements of a (B, H, N, kD) operand
  long long b, h, n;
};

__device__ __forceinline__ long long row_at(const Layout& l, int bi, int hi, int row) {
  return (long long)bi * l.b + (long long)hi * l.h + (long long)row * l.n;
}

// 16-byte cp.async that writes zeros where !valid (src-size 0).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Rows [row0, row0 + kRows) of one (image, head) of an operand into a
// swizzled bf16 tile, rows at or past n as zeros. bf16 rows by cp.async (the
// caller commits), f32 rows rounded to bf16 and stored.
template <typename T>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst, const T* __restrict__ base,
                                          const Layout& l, int bi, int hi, int row0, int n) {
  for (int e = threadIdx.x; e < kRows * 8; e += kThreads) {
    const int r = e >> 3, ch = e & 7, row = row0 + r;
    const bool valid = row < n;
    const T* src = base + row_at(l, bi, hi, valid ? row : 0) + 8 * ch;
    bf16* d = dst + swz64(r, 8 * ch);
    if constexpr (sizeof(T) == 2) {
      cp_async16_zfill(d, src, valid);
    } else {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (valid) {
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        u = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w), pack_bf16x2(b.x, b.y),
                       pack_bf16x2(b.z, b.w));
      }
      *reinterpret_cast<uint4*>(d) = u;
    }
  }
}

// A fragments of rows [m0, m0 + 16) of a tile over the four 16-wide k-steps.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile, int m0, int lane) {
  const int row = m0 + (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldsm_x4(a[kk], tile + swz64(row, 16 * kk + col));
}

// acc (16 x 64) += A (16 x kD) · tileᵀ: the tile's 64 rows are the product's
// columns (B n-major: q·kᵀ, dO·vᵀ, k·qᵀ, v·dOᵀ).
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                        const bf16* tile, int lane) {
  const int row = (lane & 7) + (lane >> 4) * 8, col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, tile + swz64(16 * np + row, 16 * kk + col));
      mma_bf16_16816(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// acc (16 x kD) += A (16 x 64) · tile: the tile's rows are the reduction
// (B k-major, through ldmatrix.trans: p·v, dS·k, pᵀ·dO, dSᵀ·q).
__device__ __forceinline__ void mma_ab(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       const bf16* tile, int lane) {
  const int row = (lane & 7) + ((lane >> 3) & 1) * 8, col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + swz64(16 * kk + row, 16 * np + col));
      mma_bf16_16816(acc[2 * np], a[kk], b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
}

// Accumulators (16 x 64, f32) → bf16 A fragments of the next product: two
// adjacent 8-column n-tiles are one 16-wide k-step.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(acc[2 * kk][0], acc[2 * kk][1]);
    a[kk][1] = pack_bf16x2(acc[2 * kk][2], acc[2 * kk][3]);
    a[kk][2] = pack_bf16x2(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    a[kk][3] = pack_bf16x2(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

// Rows [row0 + m0, +16) of a warp's (16 x kD) accumulators, times `scale`
// (per accumulator row half), into rows < n of an operand.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ base, const Layout& l, int bi, int hi,
                                           int row0, int n, const float (&acc)[8][4],
                                           float s_lo, float s_hi, int m0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + m0 + g + 8 * half;
    if (row >= n) continue;
    const float s = half ? s_hi : s_lo;
    T* dst = base + row_at(l, bi, hi, row) + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      store2(dst + 8 * nt, acc[nt][2 * half] * s, acc[nt][2 * half + 1] * s);
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (image·head, 64-query tile), looping over key tiles.
// lse (natural log) of each row < n to lse[bh·n + row].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, Layout in,
    T* __restrict__ o, Layout ol, float* __restrict__ lse, int heads, int n, float scale_log2) {
  __shared__ __align__(128) bf16 skv[2][2][kTile];  // [buffer][k, v]; q first in buffer 1
  const int bh = blockIdx.x, bi = bh / heads, hi = bh - bi * heads;
  const int q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, m0 = 16 * (threadIdx.x >> 5), t = lane & 3;
  const int tiles = (n + kRows - 1) / kRows;

  uint32_t qa[4][4], pa[4][4];
  load_tile(skv[1][0], q, in, bi, hi, q0, n);
  load_tile(skv[0][0], k, in, bi, hi, 0, n);
  load_tile(skv[0][1], v, in, bi, hi, 0, n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_a(qa, skv[1][0], m0, lane);
  __syncthreads();  // buffer 1 is free for the first prefetch

  float acc[8][4], s[8][4];
  zero(acc);
  // Running max (base 2, of sm_scale·log2(e)·q·k) and sum of this lane's two rows.
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles) {
      load_tile(skv[buf ^ 1][0], k, in, bi, hi, (j + 1) * kRows, n);
      load_tile(skv[buf ^ 1][1], v, in, bi, hi, (j + 1) * kRows, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    zero(s);
    mma_abt(s, qa, skv[buf][0], lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kRows + 8 * nt + 2 * t + (e & 1);
        s[nt][e] = key < n ? s[nt][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float m_use[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      // A row with no key yet (never at tile 0, which holds key 0) keeps exp2 finite.
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m_use[e >> 1]);  // masked keys: exp2(-inf) = 0
        sum[e >> 1] += s[nt][e];
        acc[nt][e] *= alpha[e >> 1];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + quad_sum(sum[r]);
    to_a(pa, s);  // p rounded to bf16 (v's dtype) before p·v
    mma_ab(acc, pa, skv[buf][1], lane);
    __syncthreads();  // every warp is done with buf before the next loads refill it
  }

  store_rows(o, ol, bi, hi, q0, n, acc, 1.f / l_run[0], 1.f / l_run[1], m0, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + m0 + (lane >> 2) + 8 * r;
      if (row < n) lse[(long long)bh * n + row] = (m_run[r] + log2f(l_run[r])) * 0.6931471805599453f;
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (image·head, 64-query tile), looping over key tiles:
//   P = exp(s − lse), dS = P ∘ (dO·vᵀ − D)·sm_scale, dq = dS·k.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, Layout in,
    const T* __restrict__ dout, Layout ol, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int heads, int n, float scale_log2,
    float sm_scale) {
  __shared__ __align__(128) bf16 skv[2][2][kTile];  // [buffer][k, v]; q, dO first in buffer 1
  const int bh = blockIdx.x, bi = bh / heads, hi = bh - bi * heads;
  const int q0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, m0 = 16 * (threadIdx.x >> 5), t = lane & 3;
  const int tiles = (n + kRows - 1) / kRows;

  uint32_t qa[4][4], da[4][4], sa[4][4];
  load_tile(skv[1][0], q, in, bi, hi, q0, n);
  load_tile(skv[1][1], dout, ol, bi, hi, q0, n);
  load_tile(skv[0][0], k, in, bi, hi, 0, n);
  load_tile(skv[0][1], v, in, bi, hi, 0, n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_a(qa, skv[1][0], m0, lane);
  load_a(da, skv[1][1], m0, lane);
  __syncthreads();

  float lse2[2], d_row[2];  // rows past n: zero q and dO, so dS = 0 there
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + m0 + (lane >> 2) + 8 * r;
    const long long at = (long long)bh * n + row;
    lse2[r] = row < n ? lse[at] * kLog2e : 0.f;
    d_row[r] = row < n ? delta[at] : 0.f;
  }

  float dq_acc[8][4], s[8][4], dp[8][4];
  zero(dq_acc);
  for (int j = 0; j < tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < tiles) {
      load_tile(skv[buf ^ 1][0], k, in, bi, hi, (j + 1) * kRows, n);
      load_tile(skv[buf ^ 1][1], v, in, bi, hi, (j + 1) * kRows, n);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    zero(s);
    zero(dp);
    mma_abt(s, qa, skv[buf][0], lane);
    mma_abt(dp, da, skv[buf][1], lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * kRows + 8 * nt + 2 * t + (e & 1);
        const float p = key < n ? exp2f(s[nt][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - d_row[e >> 1]) * sm_scale;
      }
    to_a(sa, s);  // dS·sm_scale rounded to bf16 (k's dtype) before dS·k
    mma_ab(dq_acc, sa, skv[buf][0], lane);
    __syncthreads();
  }
  store_rows(dq, in, bi, hi, q0, n, dq_acc, 1.f, 1.f, m0, lane);
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (image·head, 64-key tile), looping over query tiles
// with the transposed products (rows = keys):
//   Pᵀ = exp(sᵀ − lse), dv = Pᵀ·dO, dSᵀ = Pᵀ ∘ (v·dOᵀ − D)·sm_scale, dk = dSᵀ·q.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, Layout in,
    const T* __restrict__ dout, Layout ol, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int heads, int n,
    float scale_log2, float sm_scale) {
  __shared__ __align__(128) bf16 sqd[2][2][kTile];  // [buffer][q, dO]; k, v first in buffer 1
  __shared__ float srow[2][2][kRows];                // [buffer][lse·log2(e), D]
  const int bh = blockIdx.x, bi = bh / heads, hi = bh - bi * heads;
  const int k0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, m0 = 16 * (threadIdx.x >> 5), t = lane & 3;
  const int tiles = (n + kRows - 1) / kRows;
  // Query rows past n: zero q and dO, and zero lse and D, so Pᵀ·dO and dSᵀ vanish.
  auto load_rows = [&](int buf, int row0) {
    if (threadIdx.x < kRows) {
      const int row = row0 + threadIdx.x;
      const long long at = (long long)bh * n + row;
      srow[buf][0][threadIdx.x] = row < n ? lse[at] * kLog2e : 0.f;
      srow[buf][1][threadIdx.x] = row < n ? delta[at] : 0.f;
    }
  };

  uint32_t ka[4][4], va[4][4], pa[4][4];
  load_tile(sqd[1][0], k, in, bi, hi, k0, n);
  load_tile(sqd[1][1], v, in, bi, hi, k0, n);
  load_tile(sqd[0][0], q, in, bi, hi, 0, n);
  load_tile(sqd[0][1], dout, ol, bi, hi, 0, n);
  load_rows(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  load_a(ka, sqd[1][0], m0, lane);
  load_a(va, sqd[1][1], m0, lane);
  __syncthreads();
  float dk_acc[8][4], dv_acc[8][4], s[8][4], dp[8][4];
  zero(dk_acc);
  zero(dv_acc);
  for (int i = 0; i < tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < tiles) {
      load_tile(sqd[buf ^ 1][0], q, in, bi, hi, (i + 1) * kRows, n);
      load_tile(sqd[buf ^ 1][1], dout, ol, bi, hi, (i + 1) * kRows, n);
      load_rows(buf ^ 1, (i + 1) * kRows);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    zero(s);
    mma_abt(s, ka, sqd[buf][0], lane);  // sᵀ: rows = keys, columns = queries
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = exp2f(s[nt][e] * scale_log2 - srow[buf][0][8 * nt + 2 * t + (e & 1)]);
    to_a(pa, s);  // Pᵀ rounded to bf16 (dO's dtype) before Pᵀ·dO
    mma_ab(dv_acc, pa, sqd[buf][1], lane);
    zero(dp);
    mma_abt(dp, va, sqd[buf][1], lane);  // (dO·vᵀ)ᵀ
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] *= (dp[nt][e] - srow[buf][1][8 * nt + 2 * t + (e & 1)]) * sm_scale;
    to_a(pa, s);  // dSᵀ·sm_scale rounded to bf16 before dSᵀ·q
    mma_ab(dk_acc, pa, sqd[buf][0], lane);
    __syncthreads();
  }
  store_rows(dk, in, bi, hi, k0, n, dk_acc, 1.f, 1.f, m0, lane);
  store_rows(dv, in, bi, hi, k0, n, dv_acc, 1.f, 1.f, m0, lane);
}

inline dim3 grid_of(int batch, int heads, int n) {
  return dim3((unsigned)batch * (unsigned)heads, (unsigned)((n + kRows - 1) / kRows));
}

}  // namespace flash
}  // namespace hvt

namespace {

using hvt::flash::Layout;

bool takes(int batch, int heads, int n, int d) {
  return d == hvt::flash::kD && n >= 1 && batch >= 1 && heads >= 1 &&
         (long long)batch * heads <= 0x7fffffffLL && (n + hvt::flash::kRows - 1) / hvt::flash::kRows <= 65535;
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// q, k, v (B, H, N, d) through strides (sb, sh, sn) (elements; the head dim
// contiguous), o through (ob, oh, on), lse (B·H, N) f32; dtype 0 = bf16,
// 1 = f32 for every operand. d must be 64. Returns a cudaError_t, or -1 for a
// shape the kernel does not take.
extern "C" int hvt_flash_attention_fwd(const void* q, const void* k, const void* v, long long sb,
                                       long long sh, long long sn, void* o, long long ob,
                                       long long oh, long long on, float* lse, int batch,
                                       int heads, int n, int d, float sm_scale, int dtype,
                                       void* stream) {
  if (!takes(batch, heads, n, d)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout in{sb, sh, sn}, ol{ob, oh, on};
  const dim3 grid = hvt::flash::grid_of(batch, heads, n);
  const float scale_log2 = sm_scale * hvt::kLog2e;
  if (dtype == 0)
    hvt::flash::flash_fwd_kernel<hvt::bf16><<<grid, hvt::flash::kThreads, 0, s>>>(
        static_cast<const hvt::bf16*>(q), static_cast<const hvt::bf16*>(k),
        static_cast<const hvt::bf16*>(v), in, static_cast<hvt::bf16*>(o), ol, lse, heads, n,
        scale_log2);
  else
    hvt::flash::flash_fwd_kernel<float><<<grid, hvt::flash::kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        in, static_cast<float*>(o), ol, lse, heads, n, scale_log2);
  return launched();
}

// dq of the forward above; dO through o's strides, dq through q's; delta =
// rowsum(dO∘O) (B·H, N) f32. Returns as the forward.
extern "C" int hvt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          long long sb, long long sh, long long sn,
                                          const void* dout, long long ob, long long oh,
                                          long long on, const float* lse, const float* delta,
                                          void* dq, int batch, int heads, int n, int d,
                                          float sm_scale, int dtype, void* stream) {
  if (!takes(batch, heads, n, d)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout in{sb, sh, sn}, ol{ob, oh, on};
  const dim3 grid = hvt::flash::grid_of(batch, heads, n);
  const float scale_log2 = sm_scale * hvt::kLog2e;
  if (dtype == 0)
    hvt::flash::flash_bwd_dq_kernel<hvt::bf16><<<grid, hvt::flash::kThreads, 0, s>>>(
        static_cast<const hvt::bf16*>(q), static_cast<const hvt::bf16*>(k),
        static_cast<const hvt::bf16*>(v), in, static_cast<const hvt::bf16*>(dout), ol, lse,
        delta, static_cast<hvt::bf16*>(dq), heads, n, scale_log2, sm_scale);
  else
    hvt::flash::flash_bwd_dq_kernel<float><<<grid, hvt::flash::kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        in, static_cast<const float*>(dout), ol, lse, delta, static_cast<float*>(dq), heads, n,
        scale_log2, sm_scale);
  return launched();
}

// dk and dv of the forward above, both through q's strides. Returns as the forward.
extern "C" int hvt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           long long sb, long long sh, long long sn,
                                           const void* dout, long long ob, long long oh,
                                           long long on, const float* lse, const float* delta,
                                           void* dk, void* dv, int batch, int heads, int n, int d,
                                           float sm_scale, int dtype, void* stream) {
  if (!takes(batch, heads, n, d)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout in{sb, sh, sn}, ol{ob, oh, on};
  const dim3 grid = hvt::flash::grid_of(batch, heads, n);
  const float scale_log2 = sm_scale * hvt::kLog2e;
  if (dtype == 0)
    hvt::flash::flash_bwd_dkv_kernel<hvt::bf16><<<grid, hvt::flash::kThreads, 0, s>>>(
        static_cast<const hvt::bf16*>(q), static_cast<const hvt::bf16*>(k),
        static_cast<const hvt::bf16*>(v), in, static_cast<const hvt::bf16*>(dout), ol, lse,
        delta, static_cast<hvt::bf16*>(dk), static_cast<hvt::bf16*>(dv), heads, n, scale_log2,
        sm_scale);
  else
    hvt::flash::flash_bwd_dkv_kernel<float><<<grid, hvt::flash::kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        in, static_cast<const float*>(dout), ol, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), heads, n, scale_log2, sm_scale);
  return launched();
}
