// The warpgroup-MMA core of the MLP half's two products, fc1 and fc2 (mlp.cu:
// the forward's, and the backward's recompute of h and the pre-LN sum), and
// of the retired block halves' four (swin_block.cu, through wg_gemm_slices),
// on Hopper's `wgmma`, the one way to the card's full bf16 tensor-core rate.
//
// out = A·Bᵀ for A (rows, K) and B (n_rows, K) bf16, both K-contiguous with
// row stride K (x or h, and a weight in nn.Linear's (out, in) layout). A
// block of kWgThreads threads, two warpgroups, owns a kWgBM x BN output tile
// (BN 64, 96 or 128), 64 rows a warpgroup: each warpgroup issues
// `wgmma.mma_async.m64nBNk16.f32.bf16.bf16` with both operands read from
// shared memory through matrix descriptors, its 64 x BN f32 sum in
// registers (BN / 2 a thread). K streams in slices of kWgBK = 64 bf16, one
// 128-byte row, through a kWgStages-deep ring filled by cp.async (every
// thread copies 16-byte pieces; rows past the matrix edge and K past its end
// are zero-filled, so M, N and K need not be multiples of the tile: K = 96
// is one slice and a half). Each slice lands in the 128-byte swizzle that
// `wgmma` reads: 16-byte piece c of row r at r·128 + ((c ^ (r mod 8))·16)
// from a 1024-byte-aligned base, so a descriptor's leading offset is unused,
// its stride 1024 bytes (eight rows), and the k16 steps of a slice advance
// its start address by 32 bytes. Slice s + 2 is copied while slice s is
// multiplied; a stage is refilled only after every warpgroup has waited for
// the products that read it (wgmma.wait_group 0 before the next barrier),
// and the copies are made visible to the tensor cores' async proxy by
// fence.proxy.async before the barrier that publishes them.
//
// The accumulator of m64nNk16 is mma.sync's m16n8 layout, one warp a 16-row
// band: value 4j + 2h + e of lane l of warp w of the warpgroup sits at row
// 16w + l/4 + 8h, column 8j + 2(l mod 4) + e (wg_pairs). A bf16 result tile
// goes out through the ring (wg_store_bf16) in whole 16-byte pieces of
// rows, not as the fragments' scattered 4-byte pairs.
//
// Two blocks an SM (256 threads, at most 128 registers a thread, 73-97 KB
// of shared memory each): one block's epilogue and its ring's first slices
// overlap the other's products. On the H100 that beat a fourth stage with
// one product group left in flight, which leaves room for one block an SM,
// at every SwinV2-T shape.
#pragma once

#include "gemm_tc.cuh"

namespace hvt {

constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kWgBM = 128;       // rows of an output tile, 64 a warpgroup
constexpr int kWgBK = 64;        // K slice: one 128-byte row of bf16, the swizzle's width
constexpr int kWgStages = 3;

// Dynamic shared memory of a block with BN-column tiles: the ring, and
// 1024 bytes to align it to the swizzle's 1024-byte pattern.
template <int BN>
constexpr size_t wg_smem() { return 1024 + (size_t)kWgStages * (kWgBM + BN) * 128; }

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  __device__ __forceinline__ static void mma(float (&d)[48], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle at shared address addr: start address / 16, leading byte offset
// 16 (unused by this layout), stride byte offset 1024 between 8-row groups,
// layout 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous products that own them.
template <int R>
__device__ __forceinline__ void wg_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A ROWS x kWgBK slice into dst, swizzled: row r from src + (r0 + r)·ld + k0,
// zeros at r0 + r >= rows or at k0 + 8c >= K.
template <int ROWS>
__device__ __forceinline__ void wg_load_slice(unsigned char* dst, const bf16* __restrict__ src,
                                              long long ld, int r0, int rows, int k0, int K) {
  static_assert(ROWS * 8 % kWgThreads == 0, "whole 16-byte pieces a thread");
#pragma unroll
  for (int it = 0; it < ROWS * 8 / kWgThreads; ++it) {
    const int i = threadIdx.x + it * kWgThreads, r = i >> 3, c = i & 7;
    const bool ok = r0 + r < rows && k0 + 8 * c < K;
    cp_async16_zfill(dst + r * 128 + ((c ^ (r & 7)) << 4),
                     ok ? src + (r0 + r) * ld + k0 + 8 * c : src, ok);
  }
}

// The block's dynamic shared memory from its first 1024-byte boundary.
__device__ __forceinline__ unsigned char* wg_smem_base() {
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  return wg_raw + ((1024 - (smem_u32(wg_raw) & 1023)) & 1023);
}

// acc = the sum of `steps` K slices of a block's kWgBM x BN tile, the
// calling thread's share of its warpgroup's 64 rows (wg_pairs):
// load(s, stage) fills `stage` with slice s (cp.async, kWgBM swizzled rows
// of A at stage, BN of B at stage + kWgBM·128; the ring commits and waits).
// Every thread of the block calls it. On return every product has
// completed, but the other warpgroup's may not: wait on the block before
// reusing the ring.
template <int BN, typename LoadFn>
__device__ __forceinline__ void wg_gemm_slices(float (&acc)[BN / 2], int steps, LoadFn load) {
  unsigned char* const sm = wg_smem_base();
  constexpr int kA = kWgBM * 128, kStage = (kWgBM + BN) * 128;
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < steps) load(s, sm + s * kStage);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kWgStages - 2>();  // slice s has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // ... for every thread; every warpgroup is done with slice s − 1
    const int next = s + kWgStages - 1;
    if (next < steps) load(next, sm + (next % kWgStages) * kStage);
    cp_async_commit();
    const uint32_t a = smem_u32(sm + (s % kWgStages) * kStage) + wg * 64 * 128;
    const uint32_t b = smem_u32(sm + (s % kWgStages) * kStage + kA);
    wg_fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk)
      Wgmma<BN>::mma(acc, wg_desc(a + 32 * kk), wg_desc(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(acc);
  }
}

// acc = A·Bᵀ for the block's tile (rows m0.., BN columns n0..), as
// wg_gemm_slices: K in ceil(K / kWgBK) slices of A's and B's rows.
template <int BN>
__device__ __forceinline__ void wg_gemm_nt(float (&acc)[BN / 2], const bf16* __restrict__ A,
                                           int rows, const bf16* __restrict__ B, int n_rows, int K,
                                           int m0, int n0) {
  wg_gemm_slices<BN>(acc, (K + kWgBK - 1) / kWgBK, [&](int s, unsigned char* d) {
    wg_load_slice<kWgBM>(d, A, K, m0, rows, s * kWgBK, K);
    wg_load_slice<BN>(d + kWgBM * 128, B, K, n0, n_rows, s * kWgBK, K);
  });
}

// fn(row, col, v0, v1) for each pair of neighbouring columns of the calling
// thread's accumulators: row m0 + 64·warpgroup + 16·warp + lane/4 (+ 8),
// col n0 + 8j + 2·(lane mod 4).
template <int BN, typename Fn>
__device__ __forceinline__ void wg_pairs(const float (&acc)[BN / 2], int m0, int n0, Fn fn) {
  const int lane = threadIdx.x & 31;
  const int r0 = m0 + 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      fn(r0 + 8 * h, c0 + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// Stores the block's kWgBM x BN tile into out (row stride ld bf16, rows
// m0.. below `rows`, columns n0..), each pair of neighbouring columns
// packed by pack(col within the tile, v0, v1): through the ring, free once
// every warpgroup has left wg_gemm_nt, into rows of BN + 8 bf16 (a
// half-warp's 4-byte writes fall in 32 distinct banks), then out in whole
// 16-byte pieces of rows, neighbouring threads on neighbouring pieces.
template <int BN, typename PackFn>
__device__ __forceinline__ void wg_store_bf16(const float (&acc)[BN / 2], PackFn pack,
                                              bf16* __restrict__ out, long long ld, int m0, int n0,
                                              int rows) {
  constexpr int kLd = BN + 8, kPieces = BN / 8;
  static_assert(kWgBM * kLd * sizeof(bf16) <= kWgStages * (kWgBM + BN) * 128, "fits the ring");
  bf16* const tile = reinterpret_cast<bf16*>(wg_smem_base());
  __syncthreads();  // every warpgroup is done with the ring
  wg_pairs<BN>(acc, 0, 0, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<uint32_t*>(tile + r * kLd + c) = pack(c, v0, v1);
  });
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kWgBM * kPieces / kWgThreads; ++it) {
    const int i = threadIdx.x + it * kWgThreads, r = i / kPieces, c = 8 * (i % kPieces);
    if (m0 + r < rows)
      *reinterpret_cast<uint4*>(out + (m0 + r) * ld + n0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * kLd + c);
  }
}

}  // namespace hvt
