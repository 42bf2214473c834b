// Flash voxel attention for Hopper (sm_90a), on tensor cores:
// out = softmax(q k^T * scale) v over flattened voxel sequences, q [B, nq,
// C], k and v [B, nkv, C], all contiguous, float32 or bfloat16, any
// C >= 1. nq may differ from nkv (cross-attention).
//
// Replaces the TPU kernel ldm3d/ops/attention.py::_flash_kernel (launched by
// _attention_pallas). It computes the same function: a running max, a
// running sum and an accumulator held in float32 over tiles of keys (online
// softmax); the ragged last key tile is masked to -inf and its V rows are
// zero; the probabilities are cast to the input type before the P.V product,
// as the TPU kernel does.
//
// Bound on an H100 SXM at the served shape [16, 64, 64, 512] in float32:
// the call moves q, k, v and out once, 4 x 2 MiB, 2.5 us at 3.35 TB/s; it
// does 4 * 16 * 64 * 64 * 512 = 134 MFLOP, 0.27 us at the TF32
// tensor-core peak. So it is memory-bound there, and launch-bound in
// practice. At [2, 4096, 4096, 64] it is bound by operations: 8.6 GFLOP,
// 17 us at the TF32 peak, 8.7 us in bfloat16.
//
// Design: FlashAttention-2 on mma.sync (mma_sm90.cuh: 3xTF32 in float32,
// m16n8k16 in bfloat16). A block of 4 warps owns a tile of 64 query rows
// (16 per warp) and a slice of CO = 64 output columns (32 where C <= 32);
// the grid is batch x query tiles x column slices, so a head width of 512
// never needs a 64 x 512 float32 accumulator: each block keeps 64 x CO,
// and S = Q K^T is recomputed over the full width for each column slice
// (2 MFLOP per 64 x 64 x 512 tile, cheap on tensor cores). At the served
// shape that is 128 blocks for 132 SMs; 32-column slices would give 256
// blocks but double the recomputed S, and ran slower in trials.
// Each (batch, query tile) reads its K and V from device memory once; the
// column slices re-read them from L2. Keys come in tiles of 64. For each
// key tile the block walks C in 128-byte slices through a 3-stage
// cp.async ring: a slice of the K tile (and of the Q tile, unless the
// whole Q tile is resident in shared memory, which it is when there are
// several key tiles and it fits in 64 KB), with the key tile's V columns
// in the stage of its last slice. Rows are padded to 144 bytes
// (conflict-free ldmatrix) and past nq, nkv and C zero-filled; row widths
// that are not a multiple of 16 bytes stage through 4- or 2-byte copies.
// S accumulates in registers (16 x 64 per warp); the online softmax runs
// on the accumulator rows with two quad shuffles per row, as one FFMA and
// one ex2 per score (scale folded into log2 e), and masks keys only in a
// ragged last tile; P becomes the A operand of P.V in registers: in bf16
// the accumulator pairs are the A fragment, in float32 the key order
// within each 8-key step is permuted (key 2t and 2t + 1 as depth t and
// t + 4) and V is read in the same order from rows padded to 4 words mod
// 32 (conflict-free). The running sum adds p before its cast, the output
// is acc / l, stored with the row and column tails masked.

#include "mma_sm90.cuh"

namespace {

using namespace ldm3d;

constexpr int kQRows = 64;          // query rows per block, 16 per warp
constexpr int kKeys = 64;           // keys per tile
constexpr int kSlice = 128;         // bytes of C per ring stage
constexpr int kPitch = kSlice + 16;
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kResidentMax = 64 * 1024;   // bytes of a resident Q tile

// Shared-memory row pitch of a V tile of CO columns: float32 rows padded
// to 4 words mod 32 (scalar fragment loads of keys 2t, 2t + 1), bf16 rows
// to 16 bytes mod 128 (ldmatrix.trans).
template <typename T, int CO>
__host__ __device__ constexpr int v_pitch() {
  return sizeof(T) == 4 ? (CO + 4) * 4 : CO * 2 + 16;
}

struct Layout {            // dynamic shared memory of one launch
  int slices;              // 128-byte slices of a row of C
  int q_pitch;             // resident Q tile pitch (0: Q streams)
  int stage;               // bytes of one ring stage
  int smem;                // bytes in all
};

template <typename T, int CO>
__host__ __device__ inline Layout layout(int C, int nkv) {
  Layout l;
  const long long row_bytes = (long long)C * sizeof(T);
  l.slices = (int)((row_bytes + kSlice - 1) / kSlice);
  const int q_pitch = l.slices * kSlice + 16;
  const bool resident = nkv > kKeys && kQRows * q_pitch <= kResidentMax;
  l.q_pitch = resident ? q_pitch : 0;
  l.stage = kKeys * kPitch + (resident ? 0 : kQRows * kPitch)
            + kKeys * v_pitch<T, CO>();
  l.smem = (resident ? kQRows * q_pitch : 0) + kStages * l.stage;
  return l;
}

// P.V for one key tile: o[16 x CO] += p[16 x 64] v[64 x CO], p in the
// S accumulator layout (s[n-tile][4]), v in shared memory.
template <typename T, int CO> struct PV;

template <int CO> struct PV<float, CO> {
  static __device__ __forceinline__ void run(float (&o)[CO / 8][4],
                                             const float (&s)[8][4],
                                             const char* vs, int lane) {
    using TC = TensorCore<float>;
    constexpr int kVP = v_pitch<float, CO>();
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {     // keys 8kk .. 8kk + 7
      // depth t <-> key 2t, depth t + 4 <-> key 2t + 1
      const TC::A a = TC::a(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const float* v0 = reinterpret_cast<const float*>(
          vs + (8 * kk + 2 * t) * kVP) + g;
      const float* v1 = reinterpret_cast<const float*>(
          vs + (8 * kk + 2 * t + 1) * kVP) + g;
#pragma unroll
      for (int nt = 0; nt < CO / 8; ++nt) {
        const TC::B b = TC::b(__float_as_uint(v0[nt * 8]),
                              __float_as_uint(v1[nt * 8]));
        TC::mma(o[nt], a, b);
      }
    }
  }
};

template <int CO> struct PV<__nv_bfloat16, CO> {
  static __device__ __forceinline__ void run(float (&o)[CO / 8][4],
                                             const float (&s)[8][4],
                                             const char* vs, int lane) {
    constexpr int kVP = v_pitch<__nv_bfloat16, CO>();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {     // keys 16kk .. 16kk + 15
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),       // p.astype(bf16)
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < CO / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kVP
                   + (np * 16 + 8 * (lane >> 4)) * 2);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
};

// CO: output columns per block (32 or 64); VEC: the byte width of the
// staging copies (16, 4 or 2).
template <typename T, int CO, int VEC>
__global__ void __launch_bounds__(kThreads)
voxel_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int nq,
                       int nkv, int C, int q_tiles, int col_tiles,
                       float scale) {
  using TC = TensorCore<T>;
  extern __shared__ __align__(128) char smem[];
  const Layout L = layout<T, CO>(C, nkv);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  int bid = blockIdx.x;
  const int ct = bid % col_tiles;
  bid /= col_tiles;
  const int q0 = (bid % q_tiles) * kQRows;
  const int b = bid / q_tiles;
  const int c0 = ct * CO;
  const long long row_bytes = (long long)C * sizeof(T);
  const char* qg = reinterpret_cast<const char*>(q)
                   + ((long long)b * nq + q0) * row_bytes;
  const char* kg = reinterpret_cast<const char*>(k)
                   + (long long)b * nkv * row_bytes;
  const char* vg = reinterpret_cast<const char*>(v)
                   + (long long)b * nkv * row_bytes + c0 * (long long)sizeof(T);
  const int iters = (nkv + kKeys - 1) / kKeys * L.slices;
  const int q_res_bytes = L.q_pitch ? kQRows * L.q_pitch : 0;
  char* ring = smem + q_res_bytes;
  const int v_off = kKeys * kPitch + (L.q_pitch ? 0 : kQRows * kPitch);

  if (L.q_pitch) {         // the whole Q tile, once
    for (int sl = 0; sl < L.slices; ++sl)
      load_tile<kQRows, kSlice, VEC, kThreads>(
          smem + sl * kSlice, L.q_pitch, qg + sl * kSlice, row_bytes,
          nq - q0, (int)row_bytes - sl * kSlice);
    cp_async_commit();
  }
  // Stage `it`: slice it % slices of key tile it / slices (K, and Q when
  // it streams), and the tile's V columns with its last slice.
  auto issue = [&](int it) {
    if (it < iters) {
      const int j = it / L.slices, sl = it - j * L.slices;
      const int key0 = j * kKeys, off = sl * kSlice;
      char* st = ring + (it % kStages) * L.stage;
      load_tile<kKeys, kSlice, VEC, kThreads>(
          st, kPitch, kg + key0 * row_bytes + off, row_bytes, nkv - key0,
          (int)(row_bytes - off));
      if (!L.q_pitch)
        load_tile<kQRows, kSlice, VEC, kThreads>(
            st + kKeys * kPitch, kPitch, qg + off, row_bytes, nq - q0,
            (int)(row_bytes - off));
      if (sl == L.slices - 1)
        load_tile<kKeys, CO * (int)sizeof(T), VEC, kThreads>(
            st + v_off, v_pitch<T, CO>(), vg + key0 * row_bytes, row_bytes,
            nkv - key0, (C - c0) * (int)sizeof(T));
    }
    cp_async_commit();
  };

  const float neg_inf = __uint_as_float(0xff800000u);
  const float scale_log2 = scale * 1.4426950408889634f;   // scale * log2(e)
  float m[2] = {neg_inf, neg_inf};      // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};              // this thread's share of the sums
  float o[CO / 8][4];
  float s[8][4];
#pragma unroll
  for (int n = 0; n < CO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();          // stage `it` landed; stage it - 1 is free
    issue(it + kStages - 1);
    const int j = it / L.slices, sl = it - j * L.slices;
    const char* st = ring + (it % kStages) * L.stage;
    const char* qs = L.q_pitch ? smem + sl * kSlice : st + kKeys * kPitch;
    const int qp = L.q_pitch ? L.q_pitch : kPitch;
    if (sl == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kSlice / 32; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, qs + warp * 16 * qp + a_offset(lane, qp) + kk * 32);
      const typename TC::A a = TC::a(r);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        ldmatrix_x4(r, st + np * 16 * kPitch + b_offset(lane, kPitch)
                       + kk * 32);
        TC::mma(s[2 * np], a, TC::b(r[0], r[1]));
        TC::mma(s[2 * np + 1], a, TC::b(r[2], r[3]));
      }
    }
    if (sl != L.slices - 1) continue;

    // Online softmax over this key tile, rows g (e = 0, 1) and g + 8, on
    // the unscaled scores: exp(scale * (s - m)) as one FFMA and one ex2
    // (scale > 0, so the running max of s is that of scale * s).
    const int key0 = j * kKeys;
    if (key0 + kKeys > nkv) {          // the ragged last tile
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + n * 8 + 2 * t + (e & 1) >= nkv) s[n][e] = neg_inf;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float alpha[2], ms[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFullMask, mx[h], 2));
      alpha[h] = exp2f((m[h] - mx[h]) * scale_log2);   // 0 at the first
      m[h] = mx[h];
      ms[h] = mx[h] * scale_log2;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(fmaf(s[n][e], scale_log2, -ms[e >> 1]));
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < CO / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    PV<T, CO>::run(o, s, st + v_off, lane);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFullMask, l[h], 1);
    l[h] += __shfl_xor_sync(kFullMask, l[h], 2);
  }
  T* ob = out + ((long long)b * nq + q0) * C + c0;
#pragma unroll
  for (int n = 0; n < CO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = warp * 16 + g + 8 * (e >> 1);
      const int col = n * 8 + 2 * t + (e & 1);
      if (q0 + row < nq && c0 + col < C)
        ob[(long long)row * C + col] = from_float<T>(o[n][e] / l[e >> 1]);
    }
}

template <typename T, int CO, int VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int nq, int nkv, int C, float scale,
                   cudaStream_t stream) {
  const Layout L = layout<T, CO>(C, nkv);
  static int configured = 0;     // the largest shared memory allowed yet
  if (L.smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        voxel_attention_kernel<T, CO, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
    if (err != cudaSuccess) return err;
    configured = L.smem;
  }
  const int q_tiles = (nq + kQRows - 1) / kQRows;
  const int col_tiles = (C + CO - 1) / CO;
  const long long blocks = (long long)batch * q_tiles * col_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  voxel_attention_kernel<T, CO, VEC><<<(unsigned)blocks, kThreads, L.smem,
                                       stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), nq, nkv, C, q_tiles,
      col_tiles, scale);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_cols(const void* q, const void* k, const void* v,
                          void* out, int batch, int nq, int nkv, int C,
                          float scale, int col_tile, cudaStream_t stream) {
  if ((long long)C * sizeof(T) % VEC != 0)
    return cudaErrorInvalidValue;     // a copy would straddle two rows
  if (col_tile == 32)
    return launch<T, 32, VEC>(q, k, v, out, batch, nq, nkv, C, scale, stream);
  if (col_tile == 64)
    return launch<T, 64, VEC>(q, k, v, out, batch, nq, nkv, C, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int batch, int nq, int nkv, int C, float scale,
                     int col_tile, int vec, cudaStream_t stream) {
  if (vec == 16)
    return dispatch_cols<T, 16>(q, k, v, out, batch, nq, nkv, C, scale,
                                col_tile, stream);
  if (vec == 4)
    return dispatch_cols<T, 4>(q, k, v, out, batch, nq, nkv, C, scale,
                               col_tile, stream);
  if constexpr (sizeof(T) == 2) {     // odd bf16 rows
    if (vec == 2)
      return dispatch_cols<T, 2>(q, k, v, out, batch, nq, nkv, C, scale,
                                 col_tile, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. col_tile (32 or 64) is the output
// columns per block; vec is the byte width of one staging copy: 16 when a
// row's bytes are a multiple of 16, else 4 when a multiple of 4, else 2
// (bfloat16 of odd C); q, k and v are 16-byte aligned. Returns the
// cudaError_t of the launch (0 on success); nothing is synchronised.
extern "C" int voxel_attention_forward(const void* q, const void* k,
                                       const void* v, void* out, int batch,
                                       int nq, int nkv, int channels,
                                       int dtype, float scale, int col_tile,
                                       int vec, void* stream) {
  if (batch <= 0 || nq <= 0 || nkv <= 0 || channels <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, out, batch, nq, nkv, channels,
                                scale, col_tile, vec, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, batch, nq, nkv,
                                        channels, scale, col_tile, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* voxel_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
