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
// What bounds it on an H100 before the FMA units: shared memory.  An SM
// reads 128 bytes of shared memory a clock and runs 128 fmaf a clock, so a
// product whose thread tile is TM x TN reads (TM + TN) / (TM TN) floats an
// fmaf and keeps up with the FMA units only at 8 x 8 (0.25 floats, one byte
// an fmaf).  Both products here use 8 x 8 tiles where the block has 128
// rows: S = Q K^T, 8 rows x 8 keys a thread (8 K and 8 Q float4 for 256
// fmaf a 4-wide step of d), and O += P V, 8 rows x 8 columns at D = 128
// (8 P and 8 V float4 for 256 fmaf every 4 keys).
//
// Design: one CTA of 256 threads (a 16 x 16 grid) per (b*h, block of BQ
// query rows), BQ = 128 (or 64 where 128-row blocks would leave SMs idle;
// the wrapper's plan chooses), the heaviest causal blocks of every head
// first.  Thread (ty, tx) owns rows ty + 16 i (i < BQ / 16), keys tx + 16 j
// (j < 8) of each 128-key tile, and output columns tx * VW + 64 p (VW = 4
// at D >= 64) of each 64-column panel p.  Shared memory holds Q (BQ x D),
// P (BQ x 128) and a ring of three slots of 128 keys x 64 columns, through
// which K and V stream as panels of 64 columns (two each at D = 112 and
// 128, one at D <= 64) by cp.async, zero-filled past T and past D.  A panel
// is issued as soon as the panel three before it has been read, so each
// copy overlaps at least a quarter of a tile's products, and a 128-key tile
// pays three barriers at D > 64 (two at D <= 64).  K panels are stored with
// their 16-byte chunks XOR-swizzled by key, so that the 8 keys a quarter
// warp reads at one d fall on 8 distinct bank groups; Q, V and P are read
// by broadcast and stored plainly.  The two half-warps write P in turn over
// the two halves of the banks.  Row maxima are reduced over the 16 threads
// of a row with shuffles every tile, row sums only at the end (each thread
// rescales its partial sum by the row's correction).  Key tiles that
// causality or the window masks whole for every row of the block are
// skipped: causal rows always keep their own key, so the result equals the
// reference's, which visits every tile; tiles that mask no key of the
// block skip the mask arithmetic.
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
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBK = 128;                // keys per tile
constexpr int kThreads = 256;           // a 16 x 16 grid of threads
constexpr int kSlots = 3;               // K/V panels in the ring
constexpr int kPanel = 64;              // columns of a K or V panel
constexpr int kKeys = kBK / 16;         // keys per thread and tile

// Panels of one K or V tile at head dim D, their width in floats, their
// 16-byte chunks a row, and the output columns a thread takes in each.
template <int D>
struct Panels {
  static constexpr int kCount = (D + kPanel - 1) / kPanel;
  static constexpr int kWidth = D < kPanel ? D : kPanel;
  static constexpr int kChunks = kWidth / 4;
  static constexpr int kVW = kWidth / 16;
};

// The XOR swizzle of the 16-byte chunks of key row `key` of a K panel: the
// 8 consecutive keys of a quarter warp land on 8 distinct bank groups.
template <int D>
__device__ __forceinline__ int k_swizzle(int key) {
  constexpr int n = Panels<D>::kChunks;
  return n >= 8 ? (key & 7) : ((key >> 1) & (n - 1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

__device__ __forceinline__ float lane(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int D, int BQ>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ * D + BQ * kBK +
                             kSlots * kBK * Panels<D>::kWidth) *
         sizeof(float);
}

// s += Q K^T over `chunks` 4-wide steps of d (a multiple of 4): qrow is row
// ty of Q at the panel's first column, kslot the panel's ring slot.  The
// steps run 4 to an iteration of one loop, so that the loop's code (some
// 1100 instructions at 8 x 8) is not repeated.
template <int D, int TM>
__device__ __forceinline__ void qk_panel(float (&s)[TM][kKeys],
                                         const float* __restrict__ qrow,
                                         const float* __restrict__ kslot,
                                         int tx, int chunks) {
  constexpr int W = Panels<D>::kWidth;
  const int sw = k_swizzle<D>(tx);      // that of every key tx + 16 j
  const float* kb = kslot + tx * W;
#pragma unroll 1
  for (int c4 = 0; c4 < chunks; c4 += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c4 + u;
      float4 kv[kKeys];
      const int off = (c ^ sw) * 4;
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kb + j * 16 * W + off);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qrow + i * 16 * D + 4 * c);
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          float t = s[i][j];
          t = fmaf(qv.x, kv[j].x, t);
          t = fmaf(qv.y, kv[j].y, t);
          t = fmaf(qv.z, kv[j].z, t);
          t = fmaf(qv.w, kv[j].w, t);
          s[i][j] = t;
        }
      }
    }
  }
}

// acc += P V for this thread's rows (prow: row ty of P) and columns (v0, v1:
// the ring slots of V's panels; v1 unused at D <= 64) over a key tile.
template <int D, int TM>
__device__ __forceinline__ void pv_tile(
    float (&acc)[TM][Panels<D>::kCount * Panels<D>::kVW],
    const float* __restrict__ prow, const float* __restrict__ v0,
    const float* __restrict__ v1, int tx) {
  constexpr int W = Panels<D>::kWidth;
  constexpr int NP = Panels<D>::kCount;
  constexpr int VW = Panels<D>::kVW;
  const float* vb[2] = {v0 + tx * VW, v1 + tx * VW};
#pragma unroll 2
  for (int kk = 0; kk < kBK; kk += 4) {
    float4 pv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      pv[i] = *reinterpret_cast<const float4*>(prow + i * 16 * kBK + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float vv[NP * VW];
#pragma unroll
      for (int w = 0; w < NP; ++w) {
        const float* row = vb[w] + (kk + u) * W;
        if constexpr (VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(row);
          vv[4 * w] = t.x; vv[4 * w + 1] = t.y;
          vv[4 * w + 2] = t.z; vv[4 * w + 3] = t.w;
        } else if constexpr (VW == 2) {
          const float2 t = *reinterpret_cast<const float2*>(row);
          vv[2 * w] = t.x; vv[2 * w + 1] = t.y;
        } else {
          vv[w] = row[0];
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float p = lane(pv[i], u);
#pragma unroll
        for (int c = 0; c < NP * VW; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int G, int S, int T_len, long long sqb, long long sqh,
                 long long sqs, long long skb, long long skh, long long sks,
                 long long svb, long long svh, long long svs, long long sob,
                 long long soh, long long sos, int causal, int window,
                 float scale) {
  using Pn = Panels<D>;
  constexpr int TM = BQ / 16;           // rows per thread
  constexpr int NP = Pn::kCount;
  constexpr int W = Pn::kWidth;
  constexpr int VW = Pn::kVW;
  constexpr int kSlot = kBK * W;        // floats of a ring slot
  constexpr int kPerTile = 2 * NP;      // panels per tile: K's, then V's
  constexpr int kLastChunks = (D - (NP - 1) * kPanel) / 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ps = Qs + BQ * D;
  float* ring = Ps + BQ * kBK;

  const int qb = gridDim.y - 1 - blockIdx.y;   // heaviest causal rows first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / G;
  const int q0 = qb * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const float* qp = q + b * sqb + h * sqh;
  const float* kp = k + b * skb + kvh * skh;
  const float* vp = v + b * svb + kvh * svh;

  // Keys any row of this block may keep: [k_lo, k_hi), in whole tiles.
  int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  k_lo = (k_lo / kBK) * kBK;
  const int k_hi = causal ? min(T_len, min(q0 + BQ, S)) : T_len;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  // Panel n of the stream (tile n / kPerTile; K's panels, then V's) into
  // ring slot n % kSlots; nothing past the last tile.  Thread tid copies
  // chunk c_ld of key rows r_ld + e * kStep, whose swizzle is the same.
  constexpr int kStep = kThreads / Pn::kChunks;
  const int c_ld = tid % Pn::kChunks;
  const int r_ld = tid / Pn::kChunks;
  const int k_dst = r_ld * W + 4 * (c_ld ^ k_swizzle<D>(r_ld));
  const int v_dst = r_ld * W + 4 * c_ld;
  auto issue = [&](int n) {
    const int t = n / kPerTile;
    if (t >= n_tiles) return;
    const int w = n - t * kPerTile;
    const bool is_v = w >= NP;
    const int col = (is_v ? w - NP : w) * kPanel + 4 * c_ld;
    const int k0 = k_lo + t * kBK + r_ld;
    const float* src = (is_v ? vp + k0 * svs : kp + k0 * sks) + col;
    const long long stride = (is_v ? svs : sks) * kStep;
    float* dst = ring + (n % kSlots) * kSlot + (is_v ? v_dst : k_dst);
#pragma unroll
    for (int e = 0; e < kBK / kStep; ++e) {
      const bool ok = k0 + e * kStep < T_len && col < D;
      cp_async16(dst + e * kStep * W, ok ? src + e * stride : kp,
                 ok ? 16 : 0);
    }
  };

  for (int id = tid; id < BQ * D / 4; id += kThreads) {
    const int r = id / (D / 4);
    const int c = id - r * (D / 4);
    const bool ok = q0 + r < S;
    cp_async16(Qs + r * D + 4 * c,
               ok ? qp + static_cast<long long>(q0 + r) * sqs + 4 * c : qp,
               ok ? 16 : 0);
  }
  issue(0);
  cp_commit();
  if constexpr (NP == 1) {
    issue(1);
    cp_commit();
  }

  float m[TM], l[TM], acc[TM][NP * VW];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NP * VW; ++c) acc[i][c] = 0.f;
  }
  const float scale2 = scale * kLog2e;  // scores in log2 units: exp2f
  const float* qrow = Qs + ty * D;
  const float* prow = Ps + ty * kBK;
  // The two half-warps (rows of either parity) write P at each step j to
  // keys of opposite parity of j, so that they fill the two halves of the
  // banks: rows of odd ty write register j ^ 1 at key tx + 16 (j ^ 1).
  const int odd = ty & 1;
  float* p_even = Ps + ty * kBK + tx + 16 * odd;
  float* p_odd = Ps + ty * kBK + tx - 16 * odd;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_lo + t * kBK;
    const int n0 = t * kPerTile;        // this tile's first panel
    float s[TM][kKeys];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;

    // K's panels in turn, one copy of the loop: wait for panel n0 + p (at
    // p = 0 with two panels nothing was issued after it), let every thread
    // see it and be done with the panel three before the ones then issued
    // (at p = 0 the last tile's P V, at p = 1 K's panel 0).
#pragma unroll 1
    for (int p = 0; p < NP; ++p) {
      if (NP == 2 && p == 0)
        cp_wait<0>();
      else
        cp_wait<1>();
      __syncthreads();
      for (int n = p == 0 ? n0 + 3 - NP : n0 + p + 2; n <= n0 + p + 2; ++n) {
        issue(n);
        cp_commit();
      }
      qk_panel<D, TM>(s, qrow + p * kPanel, ring + ((n0 + p) % kSlots) * kSlot,
                      tx, p == NP - 1 ? kLastChunks : Pn::kChunks);
    }

    // Mask, then the online-softmax update of each row.
    const bool whole = k0 + kBK <= T_len && (!causal || k0 + kBK - 1 <= q0) &&
                       (window <= 0 || q0 + BQ - 1 - k0 < window);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        float x = s[i][j] * scale2;
        if (!whole) {
          const int kpos = k0 + tx + 16 * j;
          bool ok = kpos < T_len;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && (qpos - kpos) < window;
          x = ok ? x : kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = reduce16_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < NP * VW; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float val = odd ? s[i][j ^ 1] : s[i][j];
        ((j & 1) ? p_odd : p_even)[i * 16 * kBK + 16 * j] = val;
      }
    }

    cp_wait<(NP == 2 ? 0 : 1)>();       // V landed
    __syncthreads();        // P and V visible; the last K slot is free
    issue(n0 + (NP == 2 ? 4 : 3));
    cp_commit();
    pv_tile<D, TM>(acc, prow, ring + ((n0 + NP) % kSlots) * kSlot,
                   ring + ((n0 + NP + 1) % kSlots) * kSlot, tx);
  }
  cp_wait<0>();

  float* op = o + b * sob + h * soh;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qpos = q0 + ty + 16 * i;
    const float denom = fmaxf(reduce16_sum(l[i]), 1e-30f);
    if (qpos >= S) continue;
    float* orow = op + qpos * sos;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int col = p * kPanel + tx * VW;
      if (col >= D) continue;
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(orow + col) = make_float4(
            acc[i][4 * p] / denom, acc[i][4 * p + 1] / denom,
            acc[i][4 * p + 2] / denom, acc[i][4 * p + 3] / denom);
      } else if constexpr (VW == 2) {
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(acc[i][2 * p] / denom, acc[i][2 * p + 1] / denom);
      } else {
        orow[col] = acc[i][p] / denom;
      }
    }
  }
}

template <int D, int BQ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int S, int T_len, const long long* st, int causal,
           int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_kernel<D, BQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, H / K, S,
      T_len, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// block_q: query rows a CTA, 64 or 128.
template <int D>
int dispatch_bq(const void* q, const void* k, const void* v, void* o, int B,
                int H, int K, int S, int T_len, const long long* st,
                int causal, int window, float scale, int block_q,
                cudaStream_t stream) {
  switch (block_q) {
    case 64:
      return launch<D, 64>(q, k, v, o, B, H, K, S, T_len, st, causal, window,
                           scale, stream);
    case 128:
      return launch<D, 128>(q, k, v, o, B, H, K, S, T_len, st, causal,
                            window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int H, int K, int S, int T_len, int D, const long long* st,
               int causal, int window, float scale, int block_q,
               cudaStream_t stream) {
  switch (D) {
    case 16:
      return dispatch_bq<16>(q, k, v, o, B, H, K, S, T_len, st, causal,
                             window, scale, block_q, stream);
    case 32:
      return dispatch_bq<32>(q, k, v, o, B, H, K, S, T_len, st, causal,
                             window, scale, block_q, stream);
    case 64:
      return dispatch_bq<64>(q, k, v, o, B, H, K, S, T_len, st, causal,
                             window, scale, block_q, stream);
    case 112:
      return dispatch_bq<112>(q, k, v, o, B, H, K, S, T_len, st, causal,
                              window, scale, block_q, stream);
    case 128:
      return dispatch_bq<128>(q, k, v, o, B, H, K, S, T_len, st, causal,
                              window, scale, block_q, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) for q, k, v and o in turn;
// scale: D^-0.5 rounded to f32 by the caller, as the reference rounds it;
// block_q: query rows a CTA (64 or 128), the wrapper's plan().
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int K, int S, int T, int D,
                                   const long long* strides, int causal,
                                   int window, float scale, int block_q,
                                   void* stream) {
  return dispatch_d(q, k, v, o, B, H, K, S, T, D, strides, causal, window,
                    scale, block_q, static_cast<cudaStream_t>(stream));
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
