// What the tensor-core window-attention kernels share: the forward
// (attention_fwd_tc.cuh, window_attention.cu) and the backward
// (attention_bwd_tc.cuh, window_attention_bwd.cu) run one (window, head) at a
// time on mma.sync.m16n8k16 with bf16 operands and f32 accumulation, on
// operand tiles of N <= kTcRows tokens (zero-padded to kTcRows rows) by
// kTcHeadDim, held in shared memory with their 16-byte chunks XOR-swizzled
// by row. f32 inputs enter as three bf16 pieces x = p0 + p1 + p2 (to about
// 2^-26), split on their way into shared memory.
//
// A block of kTcThreads threads owns (a chunk of images, one window id, one
// head): it loads that (window id, head)'s z once (tc_load_z) and loops over
// the chunk's windows, each window's operand tiles arriving by cp.async
// (tc_load_tiles) into one of two buffers while the other is computed.
#pragma once

#include "common.cuh"

namespace hvt {

constexpr int kTcRows = 64;      // N padded to four 16-row tiles
constexpr int kTcHeadDim = 32;   // D
constexpr int kTcThreads = 128;  // four warps
constexpr int kTcTile = kTcRows * kTcHeadDim;  // bf16 elements of one operand tile
// Row stride of the f32 z tile: 72 floats keep a half-warp's 8-byte reads
// (rows g, columns 8·tile + 2·(lane%4)) in distinct banks.
constexpr int kTcZLd = 72;
constexpr float kLog2e = 1.4426950408889634f;

// Input pieces: bf16 inputs as they are, f32 inputs in three bf16 pieces.
template <typename T>
constexpr int tc_pieces() {
  return sizeof(T) == 4 ? 3 : 1;
}

// Element (row, col) of a tile of 32-element (4-chunk) or 64-element
// (8-chunk) bf16 rows, the 16-byte chunk index XOR-swizzled by the row: the
// eight rows an ldmatrix reads at one chunk fall in eight distinct banks.
__device__ __forceinline__ int swz32(int row, int col) {
  return row * 32 + ((((col >> 3) ^ (row >> 1)) & 3) << 3) + (col & 7);
}
__device__ __forceinline__ int swz64(int row, int col) {
  return row * 64 + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// (a, b) as packed bf16 pairs hi = bf16(x) and lo = bf16(x − hi).
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16x2(a, b);
  const float2 h = unpack_bf16x2(hi);
  lo = pack_bf16x2(a - h.x, b - h.y);
}

// x = p0 + p1 + p2 for a pair (a, b), each piece a packed bf16 pair.
__device__ __forceinline__ void split3_bf16x2(float a, float b, uint32_t (&p)[3]) {
  p[0] = pack_bf16x2(a, b);
  const float2 r = unpack_bf16x2(p[0]);
  split_bf16x2(a - r.x, b - r.y, p[1], p[2]);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// zs (kTcRows x kTcZLd f32) = the (n, n) bias(+mask) zh of one window id and
// head times log2(e), -inf at or beyond row or column n: the softmax runs in
// base 2, padded keys get zero probability and padded rows none at all.
__device__ __forceinline__ void tc_load_z(float* __restrict__ zs, const float* __restrict__ zh,
                                          int n) {
  for (int e = threadIdx.x; e < kTcRows * kTcRows; e += kTcThreads) {
    const int r = e / kTcRows, c = e - r * kTcRows;
    zs[r * kTcZLd + c] = r < n && c < n ? zh[r * n + c] * kLog2e : -INFINITY;
  }
}

// Rows n.. of `tiles` consecutive operand tiles to zero. The loads write rows
// < n only, so the padding stays zero across windows.
__device__ __forceinline__ void tc_zero_pad_rows(bf16* tiles_base, int tiles, int n) {
  for (int e = threadIdx.x; e < tiles * (kTcRows - n) * 4; e += kTcThreads) {
    const int ch = e & 3, r = e >> 2, row = n + r % (kTcRows - n), t4 = r / (kTcRows - n);
    *reinterpret_cast<uint4*>(tiles_base + t4 * kTcTile + swz32(row, 8 * ch)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Rows [0, n) of kOps operand tiles of one window into dst, piece `part` of
// operand `op` at tile part·kOps + op; src(op, row) is the address of the
// row's kTcHeadDim inputs (16-byte aligned). bf16 rows go by cp.async in
// 16-byte pieces; f32 rows are split into three bf16 pieces on the way in,
// synchronously. Commits one cp.async group either way.
template <typename T, int kOps, typename SrcFn>
__device__ __forceinline__ void tc_load_tiles(bf16* __restrict__ dst, int n, SrcFn src) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kPieces = kF32 ? 8 : 4;  // 16-byte pieces per row
  for (int e = threadIdx.x; e < kOps * n * kPieces; e += kTcThreads) {
    const int op = e / (n * kPieces), rem = e - op * n * kPieces;
    const int row = rem / kPieces, pc = rem - row * kPieces;
    const T* from = src(op, row);
    if constexpr (kF32) {
      const float4 x = *reinterpret_cast<const float4*>(from + 4 * pc);
      uint32_t p01[3], p23[3];
      split3_bf16x2(x.x, x.y, p01);
      split3_bf16x2(x.z, x.w, p23);
#pragma unroll
      for (int part = 0; part < 3; ++part)
        *reinterpret_cast<uint2*>(dst + (kOps * part + op) * kTcTile + swz32(row, 4 * pc)) =
            make_uint2(p01[part], p23[part]);
    } else {
      cp_async16(dst + op * kTcTile + swz32(row, 8 * pc), from + 8 * pc);
    }
  }
  cp_async_commit();
}

// inv[r] = rsqrt(Σq² + 1e-24) of q row r (threads 0-63) and inv[kTcRows + r]
// that of k row r (threads 64-127), the pieces summed smallest first. q and
// k are operands 0 and 1 of x's kOps tiles a piece.
template <int kParts, int kOps>
__device__ __forceinline__ void tc_inverse_norms(const bf16* __restrict__ x,
                                                 float* __restrict__ inv) {
  const int tid = threadIdx.x, op = tid >> 6, row = tid & (kTcRows - 1);
  float ss = 0.f;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    float xs[8] = {};
#pragma unroll
    for (int part = kParts - 1; part >= 0; --part) {
      const uint4 u =
          *reinterpret_cast<const uint4*>(x + (part * kOps + op) * kTcTile + swz32(row, 8 * ch));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16x2(w[e]);
        xs[2 * e] += f.x;
        xs[2 * e + 1] += f.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) ss += xs[e] * xs[e];
  }
  inv[tid] = rsqrtf(ss + 1e-24f);
}

}  // namespace hvt
