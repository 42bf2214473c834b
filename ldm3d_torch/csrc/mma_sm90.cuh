// Tensor-core and copy primitives shared by the port's sm_90a kernels
// (voxel_attention.cu, codebook_nearest.cu): cp.async staging with a
// zero-filled ragged edge, ldmatrix fragment loads, and one tensor-core
// step over 32 bytes of depth for each input type.
//
// float32 runs as 3xTF32: each operand x is split into hi = x rounded to
// TF32 (to nearest, ties away, on the bit pattern: an integer add and a
// mask) and lo = x - hi (exact in float32), and a product is
// lo_a*hi_b + hi_a*lo_b + hi_a*hi_b summed in float32 by
// mma.m16n8k8.tf32, which reads the top 19 bits of each operand word, so
// lo enters truncated to TF32. hi carries 11 significant bits and lo the
// next 11, so the dropped lo_a*lo_b term and lo's truncation are near
// 2^-21 of the product: about float32 accuracy at three TF32 passes, with
// no conversion instruction. bfloat16 runs as
// one mma.m16n8k16.bf16: a product of two bf16 values is exact in
// float32.
//
// Fragment layouts (PTX ISA, warp-level mma.m16n8k8 / m16n8k16), with
// g = lane / 4 and t = lane % 4, in 32-bit words of 32 bytes of depth:
//   A (16 rows x 8 words): a0 (row g, word t), a1 (row g + 8, word t),
//                          a2 (row g, word t + 4), a3 (row g + 8, word t + 4)
//   B (8 words x 8 cols):  b0 (col g, word t), b1 (col g, word t + 4)
//   C (16 x 8 floats):     c0, c1 (row g, cols 2t, 2t + 1),
//                          c2, c3 (row g + 8, cols 2t, 2t + 1)
// One tf32 is one word and one bf16 pair is one word, so one ldmatrix
// address pattern serves both types.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ldm3d {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// VEC bytes (16, 4 or 2) from src in device memory to dst in shared
// memory, zeros when !valid (src is then not read). 16 and 4 bytes go
// through cp.async and land by cp_async_wait; 2 bytes (a bf16 row of odd
// width, which no wider copy can serve) are a plain load and store.
template <int VEC>
__device__ __forceinline__ void copy_vec(void* dst, const void* src,
                                         bool valid) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                     "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
  } else if constexpr (VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                     "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
  } else {
    static_assert(VEC == 2, "copies are 16, 4 or 2 bytes");
    *static_cast<uint16_t*>(dst) =
        valid ? *static_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ROWS x WIDTH bytes of a row-major matrix into shared memory at `pitch`
// bytes per row, by THREADS threads in copies of VEC bytes. Row r of the
// tile starts at src + r * ld; rows at or past `valid_rows` and bytes at
// or past `valid_bytes` of a row are zero. src (the tile's first byte)
// must lie inside the matrix; valid_bytes (when below WIDTH) and ld are
// multiples of VEC. Each thread owns one column of copies and every
// (THREADS * VEC / WIDTH)-th row: no division in the loop.
template <int ROWS, int WIDTH, int VEC, int THREADS>
__device__ __forceinline__ void load_tile(char* dst, int pitch,
                                          const char* src, long long ld,
                                          int valid_rows, int valid_bytes) {
  constexpr int kPerRow = WIDTH / VEC;
  static_assert(WIDTH % VEC == 0 && THREADS % kPerRow == 0
                && ROWS * kPerRow % THREADS == 0, "tile geometry");
  constexpr int kRowStep = THREADS / kPerRow;
  const int b = (int)(threadIdx.x % kPerRow) * VEC;
  const int r0 = (int)threadIdx.x / kPerRow;
  const bool col_ok = b < valid_bytes;
#pragma unroll
  for (int i = 0; i < ROWS / kRowStep; ++i) {
    const int r = r0 + i * kRowStep;
    const bool ok = col_ok && r < valid_rows;
    copy_vec<VEC>(dst + r * pitch + b, ok ? src + r * ld + b : src, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Shared-memory offset of this lane's ldmatrix.x4 row for an A fragment
// (16 rows x 32 bytes at row0, byte0): matrices (rows 0-7, bytes 0-15),
// (rows 8-15, 0-15), (rows 0-7, 16-31), (rows 8-15, 16-31) give a0..a3.
__device__ __forceinline__ int a_offset(int lane, int pitch) {
  return ((lane & 7) + 8 * ((lane >> 3) & 1)) * pitch + 16 * (lane >> 4);
}

// The same for two B fragments side by side (16 cols x 32 bytes, each
// col a row of shared memory): r0, r1 are b0, b1 of cols 0-7 and r2, r3
// of cols 8-15.
__device__ __forceinline__ int b_offset(int lane, int pitch) {
  return ((lane & 7) + 8 * (lane >> 4)) * pitch + 16 * ((lane >> 3) & 1);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One tensor-core step over 32 bytes of depth: D (16 x 8, float32) +=
// A (16 x 32 B) * B (32 B x 8), from fragments as ldmatrix loads them.
template <typename T> struct TensorCore;

template <> struct TensorCore<float> {       // 3xTF32, 8 floats of depth
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };
  static __device__ __forceinline__ A a(const uint32_t (&r)[4]) {
    A f;
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), f.hi[i], f.lo[i]);
    return f;
  }
  static __device__ __forceinline__ A a(float a0, float a1, float a2,
                                        float a3) {
    const uint32_t r[4] = {__float_as_uint(a0), __float_as_uint(a1),
                           __float_as_uint(a2), __float_as_uint(a3)};
    return a(r);
  }
  static __device__ __forceinline__ B b(uint32_t r0, uint32_t r1) {
    B f;
    split_tf32(__uint_as_float(r0), f.hi[0], f.lo[0]);
    split_tf32(__uint_as_float(r1), f.hi[1], f.lo[1]);
    return f;
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    mma_tf32(d, a.lo, b.hi[0], b.hi[1]);   // small terms first
    mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
    mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
  }
};

template <> struct TensorCore<__nv_bfloat16> {   // 16 bf16 of depth
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };
  static __device__ __forceinline__ A a(const uint32_t (&r)[4]) {
    return A{{r[0], r[1], r[2], r[3]}};
  }
  static __device__ __forceinline__ B b(uint32_t r0, uint32_t r1) {
    return B{{r0, r1}};
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a,
                                             const B& b) {
    mma_bf16(d, a.r, b.r[0], b.r[1]);
  }
};

// Two floats as one word of two bf16 (round to nearest), the first in the
// low half: the order of a fragment's depth pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace ldm3d
