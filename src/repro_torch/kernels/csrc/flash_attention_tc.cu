// Flash attention forward (prefill) on Hopper's tensor cores (sm_90a), bf16:
// GQA, causal and/or sliding window.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> _flash_kernel) for bf16: q (B,H,S,D), k/v (B,K,T,D)
// with head h reading kv head h / G (G = H/K) -> o (B,H,S,D) in bf16,
// softmax(q k^T * D^-0.5 + mask) v with an online softmax whose running max
// m, sum l and accumulator stay in f32.  The mask keeps key j for query i
// when j < T, i >= j (causal) and i - j < window (window > 0); masked scores
// take the finite -1e30, as in the reference, so a tile that masks a row
// whole is corrected by the row's next tile instead of giving NaN.  (f32
// inputs stay on the CUDA-core kernel, flash_attention.cu: the tensor cores
// would take them as TF32, which misses the f32 tolerance.)
//
// Bound: operations.  At the Qwen3-4B prefill shape (B=4, H=32, K=8,
// S=T=2048, D=128, causal) the work is 137.5 GFLOP against 167.8 MB, 0.139
// ms at 989 TFLOP/s.
//
// Design (FlashAttention-2): one CTA of 4 warps per (b*h, 128-row query
// block), heaviest causal blocks first.  Each warp owns 32 query rows, two
// m16 tiles, so that every K and V fragment it loads feeds two mma.sync.
// K and V stream in 64-key tiles through a double-buffered cp.async ring in
// shared memory (the next tile's copy runs while this one is multiplied;
// rows at or past T are zero-filled).  Per tile a warp computes S = Q K^T
// with mma.sync.m16n8k16 (bf16 in, f32 out; Q and K through ldmatrix),
// masks and scales S in registers, updates its rows' m and l with quad
// shuffles (the four lanes that share a row), rounds P to bf16 in
// registers, where the accumulator fragments of two n8 tiles of S are
// exactly the A fragment of one k16 step of P V, and accumulates O += P V
// (V through ldmatrix.trans).  l sums the rounded P, so the weights P V
// applies are normalised exactly.  Key tiles that causality or the window
// masks whole for every row of the block are skipped; tiles that no row
// masks skip the mask arithmetic.  Rows of the shared buffers are padded by
// 16 bytes (D + 8 elements: an odd number of 16-byte units) so that the
// eight rows one ldmatrix reads fall in distinct banks.  D in {16, 32, 64,
// 112, 128}: at D=112, Q K^T takes 7 k16 steps and P V 14 n8 tiles.
//
// Alternatives timed on the H100 and dropped as slower: 16 rows per warp
// (with 4 or 8 warps), 32-key tiles, and issuing each fragment's ldmatrix
// one step ahead of its mma.sync.
//
// Inputs are read through strides (the model passes (B,S,H,D) tensors as
// (B,H,S,D) views without a copy); the last dimension must be contiguous and
// every row 16-byte aligned.  The output is written through o's strides.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// the launch goes on the caller's stream, nothing is allocated, and the
// return value is the CUDA error of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kMT = 2;                  // m16 row tiles per warp
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16 * kMT * kWarps;  // 128 query rows per CTA
constexpr int kBKV = 64;                // keys per tile

template <int D>
constexpr size_t smem_bytes() {         // Q, then 2 K and 2 V buffers
  return static_cast<size_t>(kBQ + 4 * kBKV) * (D + 8) * sizeof(bf16);
}

// Rows r0 .. r0+rows-1 of a (n, D) matrix with row stride `stride` into
// shared memory (row stride D + 8) with cp.async; rows at or past n are 0.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int r0, int n,
                                          int rows) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * (D + 8) + col,
               ok ? src + static_cast<long long>(r0 + r) * stride + col : src,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b, float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 r = __bfloat1622float2(h);
  sum += r.x + r.y;
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                int G, int S, int T_len, long long sqb, long long sqh,
                long long sqs, long long skb, long long skh, long long sks,
                long long svb, long long svh, long long svs, long long sob,
                long long soh, long long sos, int causal, int window,
                float scale) {
  constexpr int MT = kMT;
  constexpr int BKV = kBKV;
  constexpr int LD = D + 8;             // padded row, elements
  constexpr int KS = D / 16;            // k16 steps of Q K^T
  constexpr int ND = D / 8;             // n8 tiles of P V
  constexpr int NS = BKV / 8;           // n8 tiles of S
  static_assert(D % 16 == 0 && ND % 2 == 0, "bad head dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBQ * LD;             // [2][BKV][LD]
  bf16* Vs = Ks + 2 * BKV * LD;         // [2][BKV][LD]

  const int qb = gridDim.x - 1 - blockIdx.x;   // heaviest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / G;
  const int q0 = qb * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float scale2 = scale * kLog2e;  // scores in base 2

  const bf16* qp = q + b * sqb + h * sqh;
  const bf16* kp = k + b * skb + kvh * skh;
  const bf16* vp = v + b * svb + kvh * svh;

  // Keys any row of this block may keep: [k_lo, k_hi).
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / BKV) * BKV;
  const int k_hi = causal ? min(T_len, min(q0 + kBQ, S)) : T_len;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BKV - 1) / BKV : 0;

  load_rows<D>(Qs, qp, sqs, q0, S, kBQ);
  if (n_tiles > 0) {
    load_rows<D>(Ks, kp, sks, k_lo, T_len, BKV);
    load_rows<D>(Vs, vp, svs, k_lo, T_len, BKV);
  }
  cp_async_commit();

  // This warp's rows: m16 tile i holds rows wrow + 16 i + lane/4 (c0, c1)
  // and + 8 (c2, c3).
  const int wrow = warp * 16 * MT;
  const int ra = q0 + wrow + lane / 4;
  float m[MT][2], l[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = kNegInf;
      l[i][r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();      // tile t (and, first, Q) has landed
    __syncthreads();         // and every warp is done with tile t - 1
    if (t + 1 < n_tiles) {
      const int buf = (t + 1) & 1;
      load_rows<D>(Ks + buf * BKV * LD, kp, sks, k_lo + (t + 1) * BKV,
                   T_len, BKV);
      load_rows<D>(Vs + buf * BKV * LD, vp, svs, k_lo + (t + 1) * BKV,
                   T_len, BKV);
    }
    cp_async_commit();
    const bf16* Kb = Ks + (t & 1) * BKV * LD;
    const bf16* Vb = Vs + (t & 1) * BKV * LD;
    const int k0 = k_lo + t * BKV;

    // S = Q K^T for the warp's rows and the tile's keys; the warp's Q
    // fragments come from shared memory at each k16 step, and each K
    // fragment serves both of its m16 tiles.
    float s[MT][NS][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[i][j][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], Qs + (wrow + i * 16 + lane % 16) * LD + ks * 16
                              + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kf[4];      // b0, b1 of key tile j, then of j + 1
        ldmatrix_x4(kf, Kb + (j * 8 + lane % 8 + (lane / 16) * 8) * LD
                             + ks * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16_16816(s[i][j], a[i], kf);
          mma_bf16_16816(s[i][j + 1], a[i], kf + 2);
        }
      }
    }

    // Scale, and mask unless no row of the block masks any key of the tile.
    const bool whole = k0 + BKV <= T_len
                       && (!causal || k0 + BKV - 1 <= q0)
                       && (window <= 0 || q0 + kBQ - 1 - k0 < window);
    uint32_t pf[MT][BKV / 16][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = s[i][j][r] * scale2;
          if (!whole) {
            const int kpos = k0 + j * 8 + (lane % 4) * 2 + (r & 1);
            const int qpos = ra + i * 16 + (r >> 1) * 8;
            bool ok = kpos < T_len;
            if (causal) ok = ok && qpos >= kpos;
            if (window > 0) ok = ok && (qpos - kpos) < window;
            x = ok ? x : kNegInf;
          }
          s[i][j][r] = x;
        }
      }

      // Online softmax: the rows' new max over the quad, the correction of
      // what came before, then P (rounded to bf16: the A operand of P V).
      float mx[2] = {m[i][0], m[i][1]};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[i][j][0], s[i][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[i][j][2], s[i][j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float corr = exp2f(m[i][r] - mx[r]);
        m[i][r] = mx[r];
        l[i][r] *= corr;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          acc[i][j][2 * r] *= corr;
          acc[i][j][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        pf[i][j / 2][(j % 2) * 2] =              // a0 / a2: row ra
            pack_bf16(exp2f(s[i][j][0] - m[i][0]),
                      exp2f(s[i][j][1] - m[i][0]), l[i][0]);
        pf[i][j / 2][(j % 2) * 2 + 1] =          // a1 / a3: row ra + 8
            pack_bf16(exp2f(s[i][j][2] - m[i][1]),
                      exp2f(s[i][j][3] - m[i][1]), l[i][1]);
      }
    }

    // O += P V; each V fragment serves both m16 tiles.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t vf[4];      // b0, b1 of d tile j, then of j + 1
        ldmatrix_x4_trans(vf, Vb + (kk * 16 + lane % 8
                                    + ((lane / 8) % 2) * 8) * LD
                                  + j * 8 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16_16816(acc[i][j], pf[i][kk], vf);
          mma_bf16_16816(acc[i][j + 1], pf[i][kk], vf + 2);
        }
      }
    }
  }
  cp_async_wait<0>();

  // l is the sum of this lane's share of each row; add the quad's.
  bf16* op = o + b * sob + h * soh;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float li = l[i][r];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      const int qpos = ra + i * 16 + r * 8;
      if (qpos >= S) continue;
      const float denom = fmaxf(li, 1e-30f);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int col = j * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(op + qpos * sos + col) =
            __floats2bfloat162_rn(acc[i][j][2 * r] / denom,
                                  acc[i][j][2 * r + 1] / denom);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int S, int T_len, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  flash_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, H / K, S, T_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v and o in turn;
// o's rows must be 4-byte aligned.  scale: D^-0.5 rounded to f32 by the
// caller, as the reference rounds it.
extern "C" int flash_attention_bf16_fwd(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int K, int S, int T, int D,
                                        const long long* strides, int causal,
                                        int window, float scale,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, H, K, S, T, strides, causal, window,
                        scale, s);
    case 32:
      return launch<32>(q, k, v, o, B, H, K, S, T, strides, causal, window,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, o, B, H, K, S, T, strides, causal, window,
                        scale, s);
    case 112:
      return launch<112>(q, k, v, o, B, H, K, S, T, strides, causal, window,
                         scale, s);
    case 128:
      return launch<128>(q, k, v, o, B, H, K, S, T, strides, causal, window,
                         scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
