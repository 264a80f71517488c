// Flash decoding for Hopper (sm_90a): one query token per (batch, kv head)
// and its G grouped query heads against a KV cache, f32 or bf16.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (flash_decode -> _decode_kernel): q (B,K,G,D), k/v (B,K,T,D), lengths (B,)
// -> o (B,K,G,D) in q's dtype, computed as softmax(q k^T * D^-0.5) v over the
// valid prefix t < lengths[b].  Precondition: 1 <= lengths[b] <= T.  A
// length of 0 is undefined in the reference as well (its kernel averages v
// over the padded cache, its oracle over T); the serving engine always
// passes pos + 1 >= 1.
//
// Bound: bytes.  The kernel does about 4*G*D flops per 2*D*sizeof(T) bytes
// of K and V it streams, ~2 flops per byte at G=4 in bf16, far below the
// card's ~295.  At the decode_32k shape (B=16, K=8, G=4, T=32768, D=128,
// bf16, lengths = T) it must read 2.147 GB of KV: 0.641 ms at 3.35 TB/s.
//
// Design (flash-decoding): T is split into chunks, and pass 1 runs one CTA
// of 128 threads per (chunk, b*K + kv head), so the card fills even when
// B*K alone is below its 132 SMs.  Chunks that start at or past lengths[b]
// return at once and load nothing.  Inside a chunk the CTA streams 128-key
// tiles: a group of D/8 threads (padded to a power of two: 16 at D=112)
// owns one key at a time and loads 8 elements of it (16 bytes in bf16),
// so a group reads a whole K row with coalesced 16-byte loads; the group's
// partial dot products with the G query heads, which stay in registers, are
// summed with warp shuffles.  One warp per head then updates that head's
// running max m and sum l (f32) in shared memory, and every group
// accumulates p*v for its keys into f32 registers.
// The groups' accumulators are summed in a fixed order (deterministic), and
// the chunk writes its (m, l, acc) to f32 scratch.  Pass 2 combines the
// chunks of each (b, kv head): o = sum_c e^(m_c - M) acc_c / sum_c e^(m_c - M) l_c.
//
// K and V are read through strides, so the model's (B,T,K,D) cache is read
// in place as a (B,K,T,D) view; the last dimension must be contiguous and
// every row 16-byte aligned.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// both launches go on the caller's stream, nothing is allocated (the caller
// passes the scratch), and the return value is the CUDA error of the
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;              // keys per tile
constexpr int kCombineThreads = 256;

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int32_t* __restrict__ lengths,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int K, int G, int T_len,
                      int chunk, long long sqb, long long sqk, long long sqg,
                      long long skb, long long skh, long long skt,
                      long long svb, long long svh, long long svt,
                      float scale) {
  // A key's D/8 16-byte chunks go to kLanes threads, padded to a power of
  // two so that a group divides the warp and the xor shuffles stay inside
  // it: at D=112, 14 chunks on 16 lanes, the last two idle (they load
  // nothing, add 0 to the dot products and store no accumulator).
  constexpr int kChunks = D / 8;
  constexpr int kLanes = kChunks <= 1 ? 1 : kChunks <= 2 ? 2
                       : kChunks <= 4 ? 4 : kChunks <= 8 ? 8 : 16;
  constexpr int kGroups = kThreads / kLanes;    // keys in flight per CTA
  constexpr int kPerGroup = kTile / kGroups;    // keys per group and tile
  static_assert(kChunks <= kLanes && kLanes <= 16, "bad head dim");
  __shared__ float s_p[GMAX][kTile];
  __shared__ float s_m[GMAX], s_l[GMAX], s_corr[GMAX];
  __shared__ __align__(16) float s_red[kGroups][GMAX][D];

  const int c = blockIdx.x;
  const int bk = blockIdx.y;
  const int b = bk / K;
  const int kvh = bk - b * K;
  const int len = min(lengths[b], T_len);
  const int t_begin = c * chunk;
  if (t_begin >= len) return;                   // whole chunk masked
  const int t_end = min(t_begin + chunk, len);
  const int grp = threadIdx.x / kLanes;
  const int d0 = (threadIdx.x % kLanes) * 8;
  const bool active = d0 < D;                   // false on padding lanes
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float qf[GMAX][8], acc[GMAX][8];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < G && active) {
      load8(q + b * sqb + kvh * sqk + g * sqg + d0, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  if (threadIdx.x < GMAX) {
    s_m[threadIdx.x] = kNegInf;
    s_l[threadIdx.x] = 0.f;
  }
  const T* kp = k + b * skb + kvh * skh;
  const T* vp = v + b * svb + kvh * svh;

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    // A: scores of this tile's keys, one key per group at a time.  Every
    // lane runs the shuffles; keys past t_end load nothing and score -1e30.
#pragma unroll 4
    for (int u = 0; u < kPerGroup; ++u) {
      const int j = grp + kGroups * u;
      const int t = t0 + j;
      float kf[8];
      if (t < t_end && active) {
        load8(kp + t * skt + d0, kf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = 0.f;
      }
      float dot[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) x = fmaf(qf[g][e], kf[e], x);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, off);
        dot[g] = x;
      }
      if (d0 == 0) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          s_p[g][j] = t < t_end ? dot[g] * scale : kNegInf;
      }
    }
    __syncthreads();

    // B: one warp per head updates m and l and turns scores into p.
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, s_p[g][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = expf(s_p[g][j] - m_new);
        s_p[g][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_corr[g] = corr;
        s_l[g] = s_l[g] * corr + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // C: rescale, then acc += p v for this group's keys.
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float corr = s_corr[g];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
      }
    }
#pragma unroll 4
    for (int u = 0; u < kPerGroup; ++u) {
      const int j = grp + kGroups * u;
      const int t = t0 + j;
      if (t >= t_end || !active) break;
      float vf[8];
      load8(vp + t * svt + d0, vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float p = s_p[g][j];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    __syncthreads();          // s_p is rewritten by the next tile
  }

  // Sum the groups' accumulators in a fixed order; write the chunk's part.
  if (active) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float4* dst = reinterpret_cast<float4*>(&s_red[grp][g][d0]);
      dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  const long long base = (static_cast<long long>(bk) * gridDim.x + c) * G;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kGroups; ++r) a += s_red[r][g][d];
    part_acc[(base + g) * D + d] = a;
  }
  if (threadIdx.x < G) {
    part_m[base + threadIdx.x] = s_m[threadIdx.x];
    part_l[base + threadIdx.x] = s_l[threadIdx.x];
  }
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      const int32_t* __restrict__ lengths, T* __restrict__ o,
                      int K, int G, int D, int T_len, int chunk, int n_chunks,
                      long long sob, long long sok, long long sog) {
  const int bk = blockIdx.x;
  const int b = bk / K;
  const int kvh = bk - b * K;
  const int len = min(lengths[b], T_len);
  const int n_valid = min(n_chunks, (len + chunk - 1) / chunk);
  for (int i = threadIdx.x; i < G * D; i += kCombineThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = kNegInf;
    for (int c = 0; c < n_valid; ++c)
      mx = fmaxf(mx, part_m[(static_cast<long long>(bk) * n_chunks + c) * G
                            + g]);
    float l = 0.f, a = 0.f;
    for (int c = 0; c < n_valid; ++c) {
      const long long idx = (static_cast<long long>(bk) * n_chunks + c) * G
                            + g;
      const float w = expf(part_m[idx] - mx);
      l += w * part_l[idx];
      a += w * part_acc[idx * D + d];
    }
    store1(o + b * sob + kvh * sok + g * sog + d, a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D, int GMAX>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, float* pm, float* pl, float* pa, int B, int K, int G,
           int T_len, int chunk, int n_chunks, const long long* st,
           float scale, cudaStream_t stream) {
  const int32_t* len = static_cast<const int32_t*>(lengths);
  decode_partial_kernel<T, D, GMAX><<<dim3(n_chunks, B * K), kThreads, 0,
                                      stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), len, pm, pl, pa, K, G, T_len, chunk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<B * K, kCombineThreads, 0, stream>>>(
      pm, pl, pa, len, static_cast<T*>(o), K, G, D, T_len, chunk, n_chunks,
      st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(const void* q, const void* k, const void* v,
               const void* lengths, void* o, float* pm, float* pl, float* pa,
               int B, int K, int G, int T_len, int chunk, int n_chunks,
               const long long* st, float scale, cudaStream_t s) {
  if (G <= 1)
    return launch<T, D, 1>(q, k, v, lengths, o, pm, pl, pa, B, K, G, T_len,
                           chunk, n_chunks, st, scale, s);
  if (G <= 2)
    return launch<T, D, 2>(q, k, v, lengths, o, pm, pl, pa, B, K, G, T_len,
                           chunk, n_chunks, st, scale, s);
  if (G <= 4)
    return launch<T, D, 4>(q, k, v, lengths, o, pm, pl, pa, B, K, G, T_len,
                           chunk, n_chunks, st, scale, s);
  if (G <= 8)
    return launch<T, D, 8>(q, k, v, lengths, o, pm, pl, pa, B, K, G, T_len,
                           chunk, n_chunks, st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v,
               const void* lengths, void* o, float* pm, float* pl, float* pa,
               int B, int K, int G, int T_len, int D, int chunk, int n_chunks,
               const long long* st, float scale, cudaStream_t s) {
  switch (D) {
    case 16:
      return dispatch_g<T, 16>(q, k, v, lengths, o, pm, pl, pa, B, K, G,
                               T_len, chunk, n_chunks, st, scale, s);
    case 32:
      return dispatch_g<T, 32>(q, k, v, lengths, o, pm, pl, pa, B, K, G,
                               T_len, chunk, n_chunks, st, scale, s);
    case 64:
      return dispatch_g<T, 64>(q, k, v, lengths, o, pm, pl, pa, B, K, G,
                               T_len, chunk, n_chunks, st, scale, s);
    case 112:
      return dispatch_g<T, 112>(q, k, v, lengths, o, pm, pl, pa, B, K, G,
                                T_len, chunk, n_chunks, st, scale, s);
    case 128:
      return dispatch_g<T, 128>(q, k, v, lengths, o, pm, pl, pa, B, K, G,
                                T_len, chunk, n_chunks, st, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides: q (batch, kv head, group), k and v (batch,
// kv head, position), o (batch, kv head, group).  part_m and part_l hold
// B*K*n_chunks*G floats, part_acc that times D.  chunk is a multiple of the
// 128-key tile; scale is D^-0.5 rounded to f32 by the caller.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* lengths, void* o, void* part_m,
                                void* part_l, void* part_acc, int B, int K,
                                int G, int T, int D, int chunk, int n_chunks,
                                const long long* strides, float scale,
                                int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (bf16)
    return dispatch_d<__nv_bfloat16>(q, k, v, lengths, o, pm, pl, pa, B, K, G,
                                     T, D, chunk, n_chunks, strides, scale, s);
  return dispatch_d<float>(q, k, v, lengths, o, pm, pl, pa, B, K, G, T, D,
                           chunk, n_chunks, strides, scale, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
