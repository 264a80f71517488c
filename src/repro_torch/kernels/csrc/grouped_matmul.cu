// Grouped (per-expert) matrix product for Hopper (sm_90a), f32, on the
// CUDA cores.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py (grouped_matmul ->
// _gmm_kernel) for f32: out[e] = x[e] @ w[e] for x (E,C,d) and w (E,d,f),
// summed in f32 (E,C,f).  The TPU kernel pads C, d and f to whole blocks and
// carries an f32 VMEM accumulator across a sequential d grid axis; here the d
// loop runs inside the CTA, the accumulators stay in registers, and the
// ragged edges are masked in the loads and the stores, so nothing is padded
// or copied.  bf16 inputs go to the tensor-core kernel,
// grouped_matmul_tc.cu.
//
// Bound: this kernel computes with IEEE f32 products and sums (no TF32, which
// misses the f32 tolerance), so it is held to the 67 TFLOP/s f32 rate of the
// CUDA cores; at the f32 check's shapes it is bound by operations.
//
// Design: one CTA per (tile of rows, tile of 128 output columns, expert),
// with the row tiles of one column tile next to each other in the grid, so
// that they read the same weight tile while it is in L2.  A loop over d
// stages a 16-deep slice of x and of w through shared memory as f32,
// double-buffered: the next slice is loaded from device memory into
// registers (16-byte loads) while the current one is multiplied.  Each
// thread keeps a TM x TN block of f32 accumulators.  The row tile follows
// the rows: BM = 8 for at most 8 rows (decode: one thread holds all 8 rows
// of one column, so each weight value is read from shared memory once), 32
// for at most 32 and 64 above (Grok-1's 320-row chunk in five whole
// tiles), so a CTA does no work for rows past C beyond its last partial
// tile.
//
// What bounds it on an H100: shared memory, before the FMA units.  An SM
// reads 128 bytes of shared memory a clock and runs 128 fmaf a clock; a
// thread's TM x TN tile reads TM + TN floats for TM TN fmaf a step of d.
// At 64 rows the thread tile is 8 x 8 (16 floats for 64 fmaf, as fast as
// the FMA units take them) rather than 4 x 8 (12 for 32: shared memory
// then takes 1.5 times the products' time).
//
// Operands are read through strides (element strides of the expert and row
// axes; the last axis must be contiguous).  VEC = 1 takes 16-byte loads and
// needs 16-byte-aligned rows; the wrapper passes VEC = 0 otherwise, and a
// 16-byte chunk that crosses the edge of d or f is loaded element by element.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// the launch goes on the caller's stream, nothing is allocated, and the
// return value is the CUDA error of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;                // output columns per CTA
constexpr int kBK = 16;                 // depth of one shared-memory stage

__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// 16 bytes at p (16-byte aligned) as f32.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

// The 16-byte chunk of `row` at columns [col, col + V) as f32; columns at or
// past n, and every column of a row that is out of range, read as 0.
template <typename T, bool VEC>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row, int col,
                                           int n, bool row_ok, float* out) {
  constexpr int V = 16 / sizeof(T);
  if (VEC && row_ok && col + V <= n) {
    load16(row + col, out);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      out[j] = (row_ok && col + j < n) ? to_float(row[col + j]) : 0.f;
  }
}

template <typename T, int BM, int TM, int TN, bool VEC>
__global__ void __launch_bounds__((BM / TM) * (kBN / TN))
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ o, int C, int d, int f, long long sxe,
           long long sxc, long long swe, long long swd, long long soe,
           long long soc) {
  constexpr int kThreads = (BM / TM) * (kBN / TN);
  constexpr int V = 16 / sizeof(T);     // elements per 16-byte chunk
  constexpr int kAPerRow = kBK / V;     // chunks per row of an x slice
  constexpr int kBPerRow = kBN / V;     // chunks per row of a w slice
  constexpr int kAChunks = BM * kAPerRow;
  constexpr int kBChunks = kBK * kBPerRow;
  constexpr int kAIters = (kAChunks + kThreads - 1) / kThreads;
  constexpr int kBIters = kBChunks / kThreads;
  constexpr int kNV = TN < 4 ? TN : 4;  // columns per shared-memory read
  constexpr int kNG = TN / kNV;         // column groups per thread
  constexpr int kCols = kBN / TN;       // threads across the tile's columns
  static_assert(kBChunks % kThreads == 0, "w slice must split evenly");
  static_assert(TM % 4 == 0 && TN % kNV == 0, "bad thread tile");

  __shared__ __align__(16) float As[2][kBK][BM];    // x slice, k-major
  __shared__ __align__(16) float Bs[2][kBK][kBN];   // w slice

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int e = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % kCols;
  const int ty = tid / kCols;
  const T* xe = x + e * sxe;
  const T* we = w + e * swe;

  float a_reg[kAIters][V];
  float b_reg[kBIters][V];

  // Device memory -> registers: the slice of x and w at depth k0.
  auto load_slice = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      const int c = tid + i * kThreads;
      if (c < kAChunks) {
        const int r = c / kAPerRow;
        const int kc = (c - r * kAPerRow) * V;
        load_chunk<T, VEC>(xe + (m0 + r) * sxc, k0 + kc, d, m0 + r < C,
                           a_reg[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBIters; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kBPerRow;
      const int nc = (c - r * kBPerRow) * V;
      load_chunk<T, VEC>(we + (k0 + r) * swd, n0 + nc, f, k0 + r < d,
                         b_reg[i]);
    }
  };

  // Registers -> shared buffer `buf`.
  auto store_slice = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAIters; ++i) {
      const int c = tid + i * kThreads;
      if (c < kAChunks) {
        const int r = c / kAPerRow;
        const int kc = (c - r * kAPerRow) * V;
#pragma unroll
        for (int j = 0; j < V; ++j) As[buf][kc + j][r] = a_reg[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < kBIters; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kBPerRow;
      const int nc = (c - r * kBPerRow) * V;
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(&Bs[buf][r][nc + j]) = make_float4(
            b_reg[i][j], b_reg[i][j + 1], b_reg[i][j + 2], b_reg[i][j + 3]);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (d + kBK - 1) / kBK;
  load_slice(0);
  store_slice(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int cur = t & 1;
    if (t + 1 < nk) load_slice((t + 1) * kBK);   // in flight while we multiply
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[cur][kk][ty * TM + i]);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < kNG; ++g) {
        const float* bp = &Bs[cur][kk][g * (kBN / kNG) + tx * kNV];
        if constexpr (kNV == 4) {
          const float4 v = *reinterpret_cast<const float4*>(bp);
          b[4 * g] = v.x; b[4 * g + 1] = v.y;
          b[4 * g + 2] = v.z; b[4 * g + 3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < kNV; ++j) b[kNV * g + j] = bp[j];
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < nk) store_slice(cur ^ 1);
    __syncthreads();
  }

  T* oe = o + e * soe;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
    if (row >= C) continue;
#pragma unroll
    for (int g = 0; g < kNG; ++g)
#pragma unroll
      for (int j = 0; j < kNV; ++j) {
        const int col = n0 + g * (kBN / kNG) + tx * kNV + j;
        if (col < f) store1(oe + row * soc + col, acc[i][kNV * g + j]);
      }
  }
}

template <typename T, int BM, int TM, int TN, bool VEC>
int launch(const void* x, const void* w, void* o, int E, int C, int d, int f,
           const long long* st, cudaStream_t stream) {
  const dim3 grid((C + BM - 1) / BM, (f + kBN - 1) / kBN, E);
  gmm_kernel<T, BM, TM, TN, VEC><<<grid, (BM / TM) * (kBN / TN), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(o),
      C, d, f, st[0], st[1], st[2], st[3], st[4], st[5]);
  return static_cast<int>(cudaGetLastError());
}

// tile 0: BM = 8 (8 x 1 per thread, 128 threads); 1: BM = 32 (4 x 4, 256);
// 2: BM = 64 (8 x 8, 128).
template <typename T, bool VEC>
int dispatch_tile(const void* x, const void* w, void* o, int E, int C, int d,
                  int f, const long long* st, int tile, cudaStream_t stream) {
  switch (tile) {
    case 0:
      return launch<T, 8, 8, 1, VEC>(x, w, o, E, C, d, f, st, stream);
    case 1:
      return launch<T, 32, 4, 4, VEC>(x, w, o, E, C, d, f, st, stream);
    case 2:
      return launch<T, 64, 8, 8, VEC>(x, w, o, E, C, d, f, st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 6 element strides, (expert, row) for x, w and o in turn; the last
// axis of each is contiguous.  tile picks the row tile (see dispatch_tile);
// vec = 1 needs every row 16-byte aligned.
extern "C" int grouped_matmul_fwd(const void* x, const void* w, void* o,
                                  int E, int C, int d, int f,
                                  const long long* strides, int tile, int vec,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    return dispatch_tile<float, true>(x, w, o, E, C, d, f, strides, tile, s);
  return dispatch_tile<float, false>(x, w, o, E, C, d, f, strides, tile, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
