// Flash decoding on Hopper's tensor cores (sm_90a), bf16: one query token per
// (batch, kv head) and its G <= 8 grouped query heads against a KV cache, in
// one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (flash_decode -> _decode_kernel) for bf16: q (B,K,G,D), k/v (B,K,T,D),
// lengths (B,) -> o (B,K,G,D) in bf16, computed as softmax(q k^T * D^-0.5) v
// over the valid prefix t < lengths[b], with the running max m, sum l and
// accumulator in f32.  (f32 inputs stay on the CUDA-core kernel,
// flash_decode.cu: the tensor cores would take them as TF32, which misses
// the f32 tolerance.)  A length of 0 writes 0; the reference leaves it
// undefined and the serving engine always passes pos + 1 >= 1.
//
// Bound: bytes.  About 4*G*D flops per 4*D bytes of K and V, ~2 flops per
// byte at G=4, far below the card's ~295 in bf16.  At the decode_32k shape
// (B=16, K=8, G=4, T=32768, D=128, lengths = T) it must read 2.147 GB of
// KV: 0.641 ms at 3.35 TB/s.
//
// Design, one CTA of 4 warps per (chunk, b*K + kv head):
// - Tensor cores.  Per 64-key tile each warp owns 16 keys.  S = q K^T is
//   mma.sync.m16n8k16 with the G heads as the A rows (padded to 16: rows
//   8..15 are zero registers, never loaded), K through ldmatrix; P = 2^(S -
//   m) is rounded to bf16 in registers, where S's two n8 accumulator tiles
//   are exactly the A fragment of one k16 step of P V, and O += P V takes V
//   through ldmatrix.trans.  l sums the rounded P, so the weights P V
//   applies are normalised exactly.  Each warp keeps its own online softmax
//   in registers (quad shuffles for the row max), so no phase of a tile
//   waits on shared memory or on another warp.  wgmma is not used: its
//   64-row minimum would waste 60 of 64 rows.
// - An asynchronous K/V ring.  K and V tiles (64 keys, rows padded to D + 8
//   elements so that ldmatrix is conflict-free) stream through a 3-stage
//   cp.async ring: while tile i is multiplied, tiles i+1 and i+2 are in
//   flight, one __syncthreads per tile.  At D=128 a stage is 34 KB and a CTA
//   104 KB, so an SM holds two, with 68 to 139 KB in flight (3.35 TB/s over
//   132 SMs times ~1 us of latency is ~25 KB).  Each copy asks L2 for the
//   256 bytes around it, a whole K or V row at D=128, and L2 is asked for
//   the K rows of the tile after the newest in flight.  cp.async was chosen
//   over TMA: its 16-byte copies already keep that many bytes in flight,
//   and a TMA descriptor holds the cache's base address, so every call (one
//   per layer and step) would need one encoded on the host, where the
//   serving step is already bound.  Rows past the chunk's end are
//   zero-filled, never read.
// - A split sized on the device by the live length.  The host fixes the
//   grid, (split, B*K), from B*K and the SM count without reading lengths
//   (decode_attention.plan: all CTAs resident at two per SM, and a cluster
//   of at most 2 once B*K is a quarter of the SMs, as a larger one costs
//   more to launch and fold than its bandwidth gains at the path's shapes).
//   CTA r of a row takes key tiles [r*n/split, (r+1)*n/split) of the
//   n = ceil(len/64) live tiles of [0, len): every CTA has work once len >=
//   split*64, and a short row no longer leaves most CTAs returning at once.
//   (The same formula is decode_attention.tc_chunk in the wrapper.)
// - One launch.  The split CTAs of a row form a thread-block cluster.  Each
//   CTA folds its 4 warps' (m, l, acc) in shared memory and stores the
//   result into rank 0's shared memory (distributed shared memory: stores,
//   which do not wait, rather than rank 0 loading from each peer), and rank
//   0 folds the parts and writes o; no f32 partial touches device memory
//   and the wrapper allocates only o.  Both folds run in a fixed order
//   (deterministic).
//
// K and V are read through strides, so the model's (B,T,K,D) cache is read
// in place as a (B,K,T,D) view; the last dimension must be contiguous and
// every row 16-byte aligned.  D in {16, 32, 64, 112, 128}: at D=112, q K^T
// takes 7 k16 steps and P V 14 n8 tiles.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// the launch goes on the caller's stream, nothing is allocated, and the
// return value is the CUDA error of the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;               // keys per tile, 16 per warp
constexpr int kStages = 3;              // tiles in the cp.async ring
constexpr int kMaxSplit = 8;            // CTAs per row: a portable cluster
constexpr int kRows = 8;                // query heads per kv head, at most

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {  // the K and V ring
  return static_cast<size_t>(2 * kStages * kTile) * (D + 8) * sizeof(bf16);
}

// Keys t0 .. t0+kTile-1 of a (T, D) matrix with row stride `stride` into
// shared memory (row stride D + 8) with cp.async; keys at or past t_end
// are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int t0,
                                          int t_end) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * 8;
    const bool ok = t0 + r < t_end;
    cp_async16_l2_256(
        dst + r * (D + 8) + col,
        ok ? src + static_cast<long long>(t0 + r) * stride + col : src,
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
__global__ void __launch_bounds__(kThreads, 2)
decode_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const int32_t* __restrict__ lengths, bf16* __restrict__ o,
                 int K, int G, int T_len, int split, long long sqb,
                 long long sqk, long long sqg, long long skb, long long skh,
                 long long skt, long long svb, long long svh, long long svt,
                 long long sob, long long sok, long long sog, float scale) {
  constexpr int LD = D + 8;             // padded row, elements
  constexpr int KS = D / 16;            // k16 steps of q K^T
  constexpr int ND = D / 8;             // n8 tiles of P V
  static_assert(D % 16 == 0 && ND % 2 == 0, "bad head dim");
  static_assert(kTile == 16 * kWarps, "a warp owns 16 keys of a tile");
  static_assert(kThreads == 2 * kTile, "two threads prefetch a K row");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [kStages][kTile][LD]
  bf16* Vs = Ks + kStages * kTile * LD;           // [kStages][kTile][LD]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bk = blockIdx.y;
  const int b = bk / K;
  const int kvh = bk - b * K;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;               // this lane's head (rows 0..7)
  const float scale2 = scale * kLog2e;  // scores in base 2

  // This CTA's share of the live tiles (decode_attention.tc_chunk).
  const int len = max(0, min(lengths[b], T_len));
  const int n_live = (len + kTile - 1) / kTile;
  const int tile_lo = rank * n_live / split;
  const int tile_hi = (rank + 1) * n_live / split;
  const int n_tiles = tile_hi - tile_lo;
  const int t_end = min(tile_hi * kTile, len);
  const bf16* kp = k + b * skb + kvh * skh;
  const bf16* vp = v + b * svb + kvh * svh;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      const int t0 = (tile_lo + s) * kTile;
      load_tile<D>(Ks + s * kTile * LD, kp, skt, t0, t_end);
      load_tile<D>(Vs + s * kTile * LD, vp, svt, t0, t_end);
    }
    cp_async_commit();
  }

  // q's A fragments: a0 = row g, columns 2(l%4) and +1 of each k16 step;
  // a2 = columns + 8; a1 = a3 = rows 8..15 = 0.
  uint32_t qa[KS][2];
  const bf16* qrow = q + b * sqb + kvh * sqk + g * sqg + 2 * (lane % 4);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    qa[ks][0] = g < G ? *reinterpret_cast<const uint32_t*>(qrow + ks * 16)
                      : 0u;
    qa[ks][1] = g < G
        ? *reinterpret_cast<const uint32_t*>(qrow + ks * 16 + 8) : 0u;
  }
  float m = kNegInf, l = 0.f;           // row g; l is this lane's share
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // and every warp is done with tile t - 1
    {
      const int nt = t + kStages - 1;
      if (nt < n_tiles) {
        const int t0 = (tile_lo + nt) * kTile;
        const int st = nt % kStages;
        load_tile<D>(Ks + st * kTile * LD, kp, skt, t0, t_end);
        load_tile<D>(Vs + st * kTile * LD, vp, svt, t0, t_end);
      }
      cp_async_commit();
      // L2 starts on the K rows of the tile after that one: a thread per
      // 128-byte line (V is not prefetched: that ran slower).
      const int tp = (tile_lo + nt + 1) * kTile + threadIdx.x / 2;
      if (nt + 1 < n_tiles && tp < t_end && (threadIdx.x % 2 == 0 || D > 64))
        prefetch_l2(kp + tp * skt + (threadIdx.x % 2) * 64);
    }
    const bf16* Kb = Ks + ((t % kStages) * kTile + warp * 16) * LD;
    const bf16* Vb = Vs + ((t % kStages) * kTile + warp * 16) * LD;
    const int k0 = (tile_lo + t) * kTile + warp * 16;

    // S = q K^T for the warp's 16 keys: two n8 tiles.
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t a[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
      uint32_t kf[4];      // b0, b1 of keys 0..7, then of keys 8..15
      ldmatrix_x4(kf, Kb + (lane % 8 + (lane / 16) * 8) * LD + ks * 16
                          + ((lane / 8) % 2) * 8);
      mma_bf16_16816(s[0], a, kf);
      mma_bf16_16816(s[1], a, kf + 2);
    }

    // Scale; mask the keys past the chunk's end (its last tile only).
    float x[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kpos = k0 + j * 8 + 2 * (lane % 4) + r;
        x[j][r] = kpos < t_end ? s[j][r] * scale2 : kNegInf;
      }

    // Online softmax of row g over the quad that holds it, then P (rounded
    // to bf16: the A operand of P V).
    float mx = fmaxf(m, fmaxf(fmaxf(x[0][0], x[0][1]),
                              fmaxf(x[1][0], x[1][1])));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = exp2f(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= corr;
      acc[j][1] *= corr;
    }
    uint32_t pf[4];
    pf[0] = pack_bf16(exp2f(x[0][0] - m), exp2f(x[0][1] - m), l);
    pf[1] = 0u;
    pf[2] = pack_bf16(exp2f(x[1][0] - m), exp2f(x[1][1] - m), l);
    pf[3] = 0u;

    // O += P V over the warp's 16 keys.
#pragma unroll
    for (int j = 0; j < ND; j += 2) {
      uint32_t vf[4];      // b0, b1 of d tile j, then of j + 1
      ldmatrix_x4_trans(vf, Vb + (lane % 8 + ((lane / 8) % 2) * 8) * LD
                                + j * 8 + (lane / 16) * 8);
      mma_bf16_16816(acc[j], pf, vf);
      mma_bf16_16816(acc[j + 1], pf, vf + 2);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                 // this CTA's ring is free

  // The ring, once free, holds rank 0's inbox, one part per rank of the
  // cluster, and after it this CTA's warps' parts.  A part is kRows rows
  // of D accumulators, then the kRows m and the kRows l.
  constexpr int kPart = kRows * D + 2 * kRows;
  float* inbox = reinterpret_cast<float*>(smem_raw);  // [kMaxSplit][kPart]
  float* w_part = inbox + kMaxSplit * kPart;          // [kWarps][kPart]
  static_assert((kMaxSplit + kWarps) * kPart * sizeof(float)
                    <= smem_bytes<D>(), "the folds do not fit the ring");
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* mine = w_part + warp * kPart;
#pragma unroll
  for (int j = 0; j < ND; ++j)
    *reinterpret_cast<float2*>(&mine[g * D + j * 8 + 2 * (lane % 4)]) =
        make_float2(acc[j][0], acc[j][1]);
  if (lane % 4 == 0) {
    mine[kRows * D + g] = m;
    mine[kRows * D + kRows + g] = l;
  }
  __syncthreads();
  // Every CTA of the cluster is past its loop, so rank 0's ring is free:
  // each CTA folds its warps' parts in a fixed order and stores the result
  // into rank 0's inbox (distributed shared memory).
  cluster.sync();
  float* dst = cluster.map_shared_rank(inbox, 0) + rank * kPart;
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int gg = i / D;
    float mw = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mw = fmaxf(mw, w_part[w * kPart + kRows * D + gg]);
    float a = 0.f, lw = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = w_part + w * kPart;
      const float e = exp2f(pw[kRows * D + gg] - mw);
      a += e * pw[i];
      lw += e * pw[kRows * D + kRows + gg];
    }
    dst[i] = a;
    if (i - gg * D == 0) {
      dst[kRows * D + gg] = mw;
      dst[kRows * D + kRows + gg] = lw;
    }
  }
  cluster.sync();

  // Rank 0 folds the parts, rank by rank, and writes o.  An idle CTA's part
  // is (m = -1e30, l = 0, acc = 0) and weighs nothing.
  if (rank == 0) {
    bf16* op = o + b * sob + kvh * sok;
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int gg = i / D;
      float mc = kNegInf;
      for (int r = 0; r < split; ++r)
        mc = fmaxf(mc, inbox[r * kPart + kRows * D + gg]);
      float a = 0.f, lc = 0.f;
      for (int r = 0; r < split; ++r) {
        const float* pr = inbox + r * kPart;
        const float e = exp2f(pr[kRows * D + gg] - mc);
        a += e * pr[i];
        lc += e * pr[kRows * D + kRows + gg];
      }
      op[gg * sog + (i - gg * D)] =
          __float2bfloat16_rn(a / fmaxf(lc, 1e-30f));
    }
  }
}

template <int D>
cudaLaunchConfig_t config(dim3 grid, int split, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<D>();
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, int B, int K, int G, int T_len, int split,
           const long long* st, float scale, cudaStream_t stream) {
  if (G < 1 || G > kRows || split < 1 || split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      decode_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config<D>(dim3(split, B * K), split, stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg, decode_tc_kernel<D>, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int32_t*>(lengths), static_cast<bf16*>(o), K, G,
      T_len, split, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int max_clusters(int split, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<D>(dim3(split, 1), split, 0, &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, decode_tc_kernel<D>, &cfg));
}

}  // namespace

// strides: 12 element strides: q (batch, kv head, group), k and v (batch,
// kv head, position), o (batch, kv head, group); o's rows are written
// element by element.  split: CTAs (a cluster) per row, 1..8.  scale:
// D^-0.5 rounded to f32 by the caller, as the reference rounds it.
extern "C" int flash_decode_bf16_fwd(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* o, int B, int K, int G, int T,
                                     int D, int split,
                                     const long long* strides, float scale,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, lengths, o, B, K, G, T, split, strides,
                        scale, s);
    case 32:
      return launch<32>(q, k, v, lengths, o, B, K, G, T, split, strides,
                        scale, s);
    case 64:
      return launch<64>(q, k, v, lengths, o, B, K, G, T, split, strides,
                        scale, s);
    case 112:
      return launch<112>(q, k, v, lengths, o, B, K, G, T, split, strides,
                         scale, s);
    case 128:
      return launch<128>(q, k, v, lengths, o, B, K, G, T, split, strides,
                         scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many clusters of `split` CTAs of the head-dim-D kernel the card can
// hold at once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int flash_decode_bf16_max_clusters(int D, int split, int* out) {
  switch (D) {
    case 16: return max_clusters<16>(split, out);
    case 32: return max_clusters<32>(split, out);
    case 64: return max_clusters<64>(split, out);
    case 112: return max_clusters<112>(split, out);
    case 128: return max_clusters<128>(split, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
