// Codebook nearest-neighbour for Hopper (sm_90a), on tensor cores: for
// activations x [N, D] and a codebook c [K, D], idx[n] = argmin_k
// (||c_k||^2 - 2 x_n . c_k) as int32, ties to the smallest k. x and c are
// contiguous and of one type, float32 or bfloat16 (the wrapper casts the
// codebook to x's type); ||c||^2 is float32, computed by the wrapper from
// the uncast codebook. N, K and D are any positive counts: ragged row and
// code tiles and the depth tail are zero-filled in shared memory.
//
// Replaces the TPU kernel ldm3d/ops/quantize.py::_nearest_kernel (launched
// by _nearest_indices_pallas). It computes the same function: the distance
// matmul and the argmin are fused, so the N x K distance matrix is never
// written to device memory, and products are summed in float32.
//
// Bound on an H100 SXM at the flagship train shape, N = 4096 (batch 8 of
// 8^3 latents), D = 256, K = 1024: 2 * N * D * K = 2.15 GFLOP, 4.3 us at
// the TF32 tensor-core peak (495 TFLOP/s) and 2.2 us in bfloat16
// (989 TFLOP/s); it reads 5.3 MB (x and c in float32), 1.6 us at
// 3.35 TB/s. So it is bound by operations, on the tensor cores.
//
// Design. Arithmetic (mma_sm90.cuh): bfloat16 runs on mma.m16n8k16 with
// float32 sums; float32 runs as 3xTF32 on mma.m16n8k8 (hi/lo split of
// both operands, three passes). One TF32 pass keeps about 3 decimal
// digits, which at distances of O(500) flips argmins by more than the
// float32 reference allows; 3xTF32 keeps about float32's 7.
// Tiles: a block of 8 warps owns 128 rows of x and walks its share of K
// in tiles of 128 codes; warp (wm, wn) of a 4 x 2 grid holds 32 rows x 64
// codes of dot products in registers (2 x 8 mma tiles). 128 rows rather
// than 64 halve the code tiles' re-reads from L2 (one per row tile). Depth streams in
// 128-byte slices of the x tile and of the code tile through a 3-stage
// cp.async ring (zero-filled past N, K and D; rows whose width is not a
// multiple of 16 bytes stage through 4- or 2-byte copies); rows are padded
// to 144 bytes, so the 8 row addresses of every ldmatrix fall in 32
// distinct banks. A tensor-core step splits each fragment into hi/lo once
// in registers and reuses it across the warp's 8 code tiles (A) or 2 row
// tiles (B). Epilogue: c_sq - 2 s for each accumulator, a running
// (distance, code) minimum per row with a strict <, codes in increasing
// order, so equal distances keep the first code. The rows' minima then
// become one 64-bit key each, the order-preserving bits of the float32
// distance above the code index, so one unsigned min keeps the smaller
// distance and, on equal distances, the smaller index: the tie rule of
// jnp.argmin. The key min runs over the quad (shuffles), the two code
// warps (shared memory) and, since N = 4096 gives only 32 row tiles, over
// K splits across gridDim.y: each split writes its key per row to scratch
// and a second small kernel takes the minimum over the splits and writes
// the int32 index. One call is these two launches.

#include "mma_sm90.cuh"

namespace {

using namespace ldm3d;

constexpr int kRows = 128;             // rows of x per block
constexpr int kRowWarps = kRows / 32;  // warps along the rows (x 2 codes)
constexpr int kCodes = 128;            // codes per tile
constexpr int kSlice = 128;            // bytes of depth per ring stage
constexpr int kPitch = kSlice + 16;    // shared-memory row pitch, bytes
constexpr int kStages = 3;
constexpr int kThreads = 64 * kRowWarps;
constexpr int kStageBytes = (kRows + kCodes) * kPitch;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr unsigned long long kNone = ~0ull;

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

// VEC: the byte width of the staging copies (16, 4 or 2).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
codebook_nearest_kernel(const T* __restrict__ x, const T* __restrict__ cb,
                        const float* __restrict__ csq,
                        unsigned long long* __restrict__ part, int N, int K,
                        int D, int tiles_per_split) {
  using TC = TensorCore<T>;
  extern __shared__ __align__(128) char smem[];
  __shared__ unsigned long long red[2][kRows];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp % kRowWarps;      // rows wm * 32 .. + 31
  const int wn = warp / kRowWarps;      // codes wn * 64 .. + 63 of a tile
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * kRows;
  const int code_begin = blockIdx.y * tiles_per_split * kCodes;
  const int code_end = min(K, code_begin + tiles_per_split * kCodes);
  const long long row_bytes = (long long)D * sizeof(T);
  const int slices = (int)((row_bytes + kSlice - 1) / kSlice);
  const int iters = (code_end - code_begin + kCodes - 1) / kCodes * slices;
  const char* xg = reinterpret_cast<const char*>(x) + row0 * row_bytes;
  const char* cg = reinterpret_cast<const char*>(cb);

  // Stage `it` of the ring: depth slice it % slices of the x tile and of
  // code tile it / slices.
  auto issue = [&](int it) {
    if (it < iters) {
      const int tile = it / slices, s = it - tile * slices;
      const int c0 = code_begin + tile * kCodes;
      const int off = s * kSlice;
      char* st = smem + (it % kStages) * kStageBytes;
      load_tile<kRows, kSlice, VEC, kThreads>(
          st, kPitch, xg + off, row_bytes, N - row0, (int)(row_bytes - off));
      load_tile<kCodes, kSlice, VEC, kThreads>(
          st + kRows * kPitch, kPitch, cg + c0 * row_bytes + off, row_bytes,
          code_end - c0, (int)(row_bytes - off));
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // This thread's best distance and code for rows g and g + 8 of each
  // row tile; codes come in increasing order, so a strict < keeps the
  // first of equal distances.
  const float inf = __uint_as_float(0x7f800000u);
  float best_d[2][2] = {{inf, inf}, {inf, inf}};
  int best_c[2][2] = {{-1, -1}, {-1, -1}};

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();          // stage `it` landed; stage it - 1 is free
    issue(it + kStages - 1);
    const char* xs = smem + (it % kStages) * kStageBytes + wm * 32 * kPitch;
    const char* cs = smem + (it % kStages) * kStageBytes
                     + (kRows + wn * 64) * kPitch;
#pragma unroll
    for (int k = 0; k < kSlice / 32; ++k) {
      typename TC::A a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t r[4];
        ldmatrix_x4(r, xs + mt * 16 * kPitch + a_offset(lane, kPitch)
                       + k * 32);
        a[mt] = TC::a(r);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, cs + np * 16 * kPitch + b_offset(lane, kPitch)
                       + k * 32);
        const typename TC::B b0 = TC::b(r[0], r[1]);
        const typename TC::B b1 = TC::b(r[2], r[3]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          TC::mma(acc[mt][2 * np], a[mt], b0);
          TC::mma(acc[mt][2 * np + 1], a[mt], b1);
        }
      }
    }
    const int tile = it / slices;
    if (it - tile * slices == slices - 1) {   // the code tile is complete
      const int c0 = code_begin + tile * kCodes + wn * 64;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int code = c0 + nt * 8 + 2 * t + j;
          if (code < code_end) {
            const float c2 = csq[code];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float d = c2 - 2.f * acc[mt][nt][2 * h + j];
                if (d < best_d[mt][h] || best_c[mt][h] < 0) {
                  best_d[mt][h] = d;
                  best_c[mt][h] = code;
                }
              }
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
      }
    }
  }

  // Row wm * 32 + mt * 16 + h * 8 + g: min over the quad, then over the
  // two code warps.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned long long v =
          best_c[mt][h] < 0 ? kNone : pack(best_d[mt][h], best_c[mt][h]);
      v = umin64(v, __shfl_xor_sync(kFullMask, v, 1));
      v = umin64(v, __shfl_xor_sync(kFullMask, v, 2));
      if (t == 0) red[wn][wm * 32 + mt * 16 + h * 8 + g] = v;
    }
  __syncthreads();
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    if (row0 + r < N)
      part[(size_t)blockIdx.y * N + row0 + r] = umin64(red[0][r], red[1][r]);
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

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* cb, const float* csq,
                   unsigned long long* part, int32_t* out, int N, int K,
                   int D, int splits, cudaStream_t stream) {
  if ((long long)D * sizeof(T) % VEC != 0)
    return cudaErrorInvalidValue;     // a copy would straddle two rows
  const int code_tiles = (K + kCodes - 1) / kCodes;
  const int tiles_per_split = (code_tiles + splits - 1) / splits;
  if ((code_tiles + tiles_per_split - 1) / tiles_per_split != splits)
    return cudaErrorInvalidValue;     // every split must own codes
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        codebook_nearest_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((N + kRows - 1) / kRows, splits);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  codebook_nearest_kernel<T, VEC><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(cb), csq, part, N, K,
      D, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  codebook_nearest_finalize<<<(N + 255) / 256, 256, 0, stream>>>(
      part, out, N, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* cb, const float* csq,
                     unsigned long long* part, int32_t* out, int N, int K,
                     int D, int splits, int vec, cudaStream_t stream) {
  if (vec == 16)
    return launch<T, 16>(x, cb, csq, part, out, N, K, D, splits, stream);
  if (vec == 4)
    return launch<T, 4>(x, cb, csq, part, out, N, K, D, splits, stream);
  if constexpr (sizeof(T) == 2) {     // odd bf16 rows
    if (vec == 2)
      return launch<T, 2>(x, cb, csq, part, out, N, K, D, splits, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `part` is scratch of splits * N
// 64-bit keys; splits must give every split at least one 128-code tile.
// vec is the byte width of one staging copy: 16 when a row's bytes are a
// multiple of 16, else 4 when a multiple of 4, else 2 (bfloat16 of odd
// D); x and the codebook are 16-byte aligned. Returns the cudaError_t of
// the launches (0 on success); nothing is synchronised.
extern "C" int codebook_nearest(const void* x, const void* cb,
                                const void* csq, void* part, void* out,
                                int N, int K, int D, int splits, int dtype,
                                int vec, void* stream) {
  if (N <= 0 || K <= 0 || D <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c2 = static_cast<const float*>(csq);
  unsigned long long* p = static_cast<unsigned long long*>(part);
  int32_t* o = static_cast<int32_t*>(out);
  if (dtype == 0)
    return (int)dispatch<float>(x, cb, c2, p, o, N, K, D, splits, vec, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(x, cb, c2, p, o, N, K, D, splits,
                                        vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* codebook_nearest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
