// Flash attention forward (prefill) for Hopper (sm_90a), f32, on the CUDA
// cores: GQA, causal and/or sliding window.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel) for f32: q (B,H,S,D), k/v (B,K,T,D) with
// head h reading kv head h / G (G = H/K) -> o (B,H,S,D), computed as
// softmax(q k^T * D^-0.5 + mask) v with an online softmax.  The mask keeps
// key j for query i when j < T, i >= j (causal) and i - j < window
// (window > 0); masked scores take the finite -1e30, as in the reference, so
// a tile that masks a row whole is corrected by the row's next tile instead
// of giving NaN.  Rows with no valid key at all (possible only without
// causality or with S > T) are undefined, as in the reference.  bf16 inputs
// go to the wgmma kernel, flash_attention_wgmma.cu.
//
// Bound: operations.  This kernel keeps IEEE f32 products and sums (no TF32,
// so f32 inputs meet 2e-5 against the plain version), which holds it to the
// 67 TFLOP/s f32 rate: at the prefill shape (B=4, H=32, K=8, S=T=2048,
// D=128, causal) 137.5 GFLOP take at least 2.05 ms.
//
// Design: one CTA of 256 threads per (b*h, 64-row query block), heaviest
// causal blocks first.  The Q block, each 32-key K and V tile and the tile's
// probabilities live in shared memory as f32 (76 KB at D=128).  Thread
// (ty, tx) of a 16x16 grid owns query rows ty + 16 i (i < 4): it computes
// their scores against keys tx + 16 j (j < 2) with 16-byte shared loads,
// keeps the rows' running max m and sum l in registers (the 16 threads of a
// row reduce with warp shuffles), and accumulates D/16 output columns of
// each row in f32.  Key tiles that causality or the window masks whole for
// every row of the block are skipped: causal rows always keep their own
// key, so the result equals the reference's, which visits every tile.
// K/V rows at or past T are zero-filled in shared memory.
//
// Inputs are read through strides (the model passes (B,S,H,D) tensors as
// (B,H,S,D) views without a copy); the last dimension must be contiguous
// and every row 16-byte aligned.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// the launch goes on the caller's stream, nothing is allocated, and the
// return value is the CUDA error of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 32;                 // keys per tile
constexpr int kThreads = 256;           // a 16 x 16 grid of threads
constexpr int kRows = kBQ / 16;         // query rows per thread
constexpr int kCols = kBK / 16;         // score columns per thread and row

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// Rows r0 .. r0+rows-1 of a (n, D) matrix with row stride `stride` into
// shared memory as f32 with row stride `ld`; rows at or past n become 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          long long stride, int r0, int n,
                                          int rows, float* dst, int ld) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d = (c - r * kChunks) * 8;
    float f[8];
    if (r0 + r < n) {
      load8(src + static_cast<long long>(r0 + r) * stride + d, f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * ld + d);
    out[0] = make_float4(f[0], f[1], f[2], f[3]);
    out[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

__device__ __forceinline__ float reduce16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float reduce16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBQ * (D + 4) + kBK * (D + 4) + kBK * D +
                             kBQ * (kBK + 4)) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int G,
                 int S, int T_len, long long sqb, long long sqh,
                 long long sqs, long long skb, long long skh, long long sks,
                 long long svb, long long svh, long long svs, long long sob,
                 long long soh, long long sos, int causal, int window,
                 float scale) {
  constexpr int kLdQK = D + 4;          // pads rows: conflict-free float4
  constexpr int kLdP = kBK + 4;
  constexpr int kNC = D / 16;           // output columns per thread and row
  // Output columns per shared load: 4 where they split evenly, else 2 or
  // 1 (D=112 gives 7 columns, read one at a time).
  constexpr int kVec = kNC % 4 == 0 ? 4 : kNC % 2 == 0 ? 2 : 1;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kLdQK;
  float* Vs = Ks + kBK * kLdQK;
  float* Ps = Vs + kBK * D;

  const int qb = gridDim.x - 1 - blockIdx.x;   // heaviest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / G;
  const int q0 = qb * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const T* qp = q + b * sqb + h * sqh;
  const T* kp = k + b * skb + kvh * skh;
  const T* vp = v + b * svb + kvh * svh;
  load_tile<T, D>(qp, sqs, q0, S, kBQ, Qs, kLdQK);

  // Keys any row of this block may keep: [k_lo, k_hi).
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / kBK) * kBK;
  const int k_hi = causal ? min(T_len, min(q0 + kBQ, S)) : T_len;

  float m[kRows], l[kRows], acc[kRows][kNC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();          // the previous tile's readers are done
    load_tile<T, D>(kp, sks, k0, T_len, kBK, Ks, kLdQK);
    load_tile<T, D>(vp, svs, k0, T_len, kBK, Vs, D);
    __syncthreads();

    // Scores s = q k^T for this thread's rows and keys.
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * kLdQK
                                                 + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * kLdQK
                                                 + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

    // Mask, then the online-softmax update of each row.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row;
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < T_len;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = reduce16_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[row * kLdP + tx + 16 * j] = p;
        psum += p;
      }
      psum = reduce16_sum(psum);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kNC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V for this thread's rows and columns.
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kLdP
                                                 + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * D;
        float vv[kNC];
#pragma unroll
        for (int jj = 0; jj < kNC / kVec; ++jj) {
          const int col = kVec * tx + 16 * kVec * jj;
          if constexpr (kVec == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + col);
            vv[4 * jj] = t.x; vv[4 * jj + 1] = t.y;
            vv[4 * jj + 2] = t.z; vv[4 * jj + 3] = t.w;
          } else if constexpr (kVec == 2) {
            const float2 t = *reinterpret_cast<const float2*>(vrow + col);
            vv[2 * jj] = t.x; vv[2 * jj + 1] = t.y;
          } else {
            vv[jj] = vrow[col];
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                        : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < kNC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* op = o + b * sob + h * soh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int col = kVec * tx + 16 * kVec * (c / kVec) + c % kVec;
      store1(op + qpos * sos + col, acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int S, int T_len, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, H / K, S, T_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int H, int K, int S, int T_len, int D, const long long* st,
               int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<float, 16>(q, k, v, o, B, H, K, S, T_len, st, causal,
                               window, scale, stream);
    case 32:
      return launch<float, 32>(q, k, v, o, B, H, K, S, T_len, st, causal,
                               window, scale, stream);
    case 64:
      return launch<float, 64>(q, k, v, o, B, H, K, S, T_len, st, causal,
                               window, scale, stream);
    case 112:
      return launch<float, 112>(q, k, v, o, B, H, K, S, T_len, st, causal,
                                window, scale, stream);
    case 128:
      return launch<float, 128>(q, k, v, o, B, H, K, S, T_len, st, causal,
                                window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v and o in turn;
// scale: D^-0.5 rounded to f32 by the caller, as the reference rounds it.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int K, int S, int T, int D,
                                   const long long* strides, int causal,
                                   int window, float scale, void* stream) {
  return dispatch_d(q, k, v, o, B, H, K, S, T, D, strides, causal, window,
                    scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
