// Codebook nearest-neighbour for Hopper (sm_90a): for activations x [N, D]
// and a codebook c [K, D], idx[n] = argmin_k (||c_k||^2 - 2 x_n . c_k) as
// int32, ties to the smallest k. x and c are contiguous and of one type,
// float32 or bfloat16 (the wrapper casts the codebook to x's type); ||c||^2
// is float32, computed by the wrapper from the uncast codebook. D is a
// multiple of 8; N and K are any positive counts (ragged tiles are masked).
//
// Replaces the TPU kernel ldm3d/ops/quantize.py::_nearest_kernel (launched
// by _nearest_indices_pallas). It computes the same function: the distance
// matmul and the argmin are fused, so the N x K distance matrix is never
// written to device memory, and products are summed in float32.
//
// Bound on an H100 SXM at the flagship train shape, N = 4096 (batch 8 of
// 8^3 latents), D = 256, K = 1024: 2 * N * D * K = 2.15 GFLOP. This kernel
// does them as float32 FMAs (67 TFLOP/s): 32 us, bound by operations. It
// reads 5.3 MB (x and c in float32), 1.6 us at 3.35 TB/s. In bfloat16 the
// tensor cores would bound it at 2.2 us (989 TFLOP/s). The design keeps
// float32 FMA on purpose: TF32 tensor cores keep about 3 decimal digits and
// would flip the argmin of near-ties against the float32 reference. A
// tensor-core version with exact tie handling is later work.
//
// Design (simple and right first): a block of 128 threads owns a tile of
// 32 rows of x and walks a range of K in tiles of 64 codes. For each code
// tile it stages 32-deep slices of the x tile and of the code tile in
// shared memory (transposed, converted to float32; 16-byte vector loads
// from device memory), and each thread accumulates a 4 x 4 register tile of
// dot products (4 rows x 4 codes) with float4 shared-memory reads. At the
// end of a code tile each thread folds its 16 distances into a running
// minimum per row. The minimum is kept as one 64-bit key, the
// order-preserving bits of the float32 distance above the code index, so
// one unsigned min gives the smaller distance and, on equal distances, the
// smaller index: the tie rule of jnp.argmin. The 16 threads of a row reduce
// their keys with warp shuffles. N = 4096 gives only 128 row tiles, fewer
// than the card's 132 SMs x 4 blocks, so K is also split over gridDim.y:
// each split writes its key per row to scratch, and a second small kernel
// takes the minimum over the splits and writes the int32 index.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;             // rows of x per block
constexpr int kCodes = 64;            // codes per tile
constexpr int kDepth = 32;            // depth of one shared-memory slice
constexpr int kThreads = 128;
constexpr int kTx = kCodes / 4;       // threads across codes (16)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;

static_assert(kTx * (kRows / 4) == kThreads, "4 x 4 register tiles");

// 16 bytes of T at p (16-byte aligned) as floats.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Rows [row0, row0 + ROWS) x depth [d0, d0 + kDepth) of src [n_rows, D]
// into dst[d][r] (float32, transposed); rows past n_rows and depth past D
// are zero. D % 8 == 0, so a 16-byte chunk is wholly inside or outside.
template <typename T, int ROWS>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int n_rows, int row0, int D,
                                          int d0, float* dst) {
  constexpr int kVec = Vec16<T>::kN;
  constexpr int kPerRow = kDepth / kVec;
  for (int c = threadIdx.x; c < ROWS * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int dd = (c % kPerRow) * kVec;
    float v[kVec];
    if (row0 + r < n_rows && d0 + dd < D) {
      Vec16<T>::load(src + (size_t)(row0 + r) * D + d0 + dd, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[(dd + e) * ROWS + r] = v[e];
  }
}

// Order-preserving key: a smaller distance gives a smaller key, and equal
// distances order by code index.
__device__ __forceinline__ unsigned long long pack(float dist, int code) {
  unsigned bits = __float_as_uint(dist);
  if (bits == 0x80000000u) bits = 0u;               // -0 ties with +0
  bits = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((unsigned long long)bits << 32) | (unsigned)code;
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
codebook_nearest_kernel(const T* __restrict__ x, const T* __restrict__ cb,
                        const float* __restrict__ csq,
                        unsigned long long* __restrict__ part, int N, int K,
                        int D, int tiles_per_split) {
  __shared__ __align__(16) float xs[kDepth * kRows];
  __shared__ __align__(16) float cs[kDepth * kCodes];
  const int tx = threadIdx.x % kTx;     // codes tx * 4 .. + 3 of a tile
  const int ty = threadIdx.x / kTx;     // rows ty * 4 .. + 3 of the block
  const int row0 = blockIdx.x * kRows;
  const int code_begin = blockIdx.y * tiles_per_split * kCodes;
  const int code_end = min(K, code_begin + tiles_per_split * kCodes);

  unsigned long long best[4] = {kNone, kNone, kNone, kNone};
  for (int c0 = code_begin; c0 < code_end; c0 += kCodes) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kDepth) {
      __syncthreads();  // every thread is done with the previous slices
      load_tile<T, kRows>(x, N, row0, D, d0, xs);
      load_tile<T, kCodes>(cb, code_end, c0, D, d0, cs);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kDepth; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(
            &xs[d * kRows + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(
            &cs[d * kCodes + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    // Codes in increasing order, so the key's index part settles ties.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int code = c0 + tx * 4 + j;
      if (code < code_end) {
        const float c2 = csq[code];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          best[i] = umin64(best[i], pack(c2 - 2.f * acc[i][j], code));
      }
    }
  }

  // The 16 threads of one row group are lanes (ty % 2) * 16 + tx of a warp.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = kTx / 2; off > 0; off >>= 1)
      best[i] = umin64(best[i], __shfl_xor_sync(kFull, best[i], off));
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty * 4 + i;
      if (row < N) part[(size_t)blockIdx.y * N + row] = best[i];
    }
  }
}

__global__ void codebook_nearest_finalize(
    const unsigned long long* __restrict__ part, int32_t* __restrict__ out,
    int N, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  unsigned long long b = part[row];
  for (int s = 1; s < splits; ++s) b = umin64(b, part[(size_t)s * N + row]);
  out[row] = (int32_t)(b & 0xffffffffull);
}

template <typename T>
cudaError_t launch(const void* x, const void* cb, const float* csq,
                   unsigned long long* part, int32_t* out, int N, int K,
                   int D, int splits, cudaStream_t stream) {
  const int code_tiles = (K + kCodes - 1) / kCodes;
  const int tiles_per_split = (code_tiles + splits - 1) / splits;
  if ((code_tiles + tiles_per_split - 1) / tiles_per_split != splits)
    return cudaErrorInvalidValue;     // every split must own codes
  const dim3 grid((N + kRows - 1) / kRows, splits);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  codebook_nearest_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(cb), csq, part, N, K,
      D, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  codebook_nearest_finalize<<<(N + 255) / 256, 256, 0, stream>>>(
      part, out, N, splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `part` is scratch of splits * N
// 64-bit keys; splits must give every split at least one 64-code tile.
// Returns the cudaError_t of the launches (0 on success); nothing is
// synchronised.
extern "C" int codebook_nearest(const void* x, const void* cb,
                                const void* csq, void* part, void* out,
                                int N, int K, int D, int splits, int dtype,
                                void* stream) {
  if (N <= 0 || K <= 0 || D <= 0 || D % 8 != 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c2 = static_cast<const float*>(csq);
  unsigned long long* p = static_cast<unsigned long long*>(part);
  int32_t* o = static_cast<int32_t*>(out);
  if (dtype == 0)
    return (int)launch<float>(x, cb, c2, p, o, N, K, D, splits, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, cb, c2, p, o, N, K, D, splits, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* codebook_nearest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
