// Grouped (per-expert) matrix product on Hopper's tensor cores (sm_90a),
// bf16 in, f32 sums, bf16 out.
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gmm.py (grouped_matmul ->
// _gmm_kernel) for bf16: out[e] = x[e] @ w[e] for x (E,C,d) and w (E,d,f),
// summed in f32 and rounded once to bf16 at the store.  bf16 products are
// exact in f32, so only the order of the f32 sums differs from the plain
// version.  (f32 inputs stay on the CUDA-core kernel, grouped_matmul.cu:
// tensor cores would take them as TF32, which misses the f32 tolerance.)
//
// Bound, at the MoE serving path's shapes (Grok-1: d=6144, f=32768, E=8):
// a 512-token prefill chunk (320 rows per expert) does 1.03 TFLOP on 3.42 GB,
// bound by operations, 1.04 ms at 989 TFLOP/s; decode (8 rows per expert)
// moves 3.23 GB of weights for 25.8 GFLOP, bound by bytes, 0.963 ms at 3.35
// TB/s.  Kimi-K2 (E=384, d=7168, f=2048) gives 8 and 28 rows per expert, both
// bound by the 11.3 GB of weights of each projection.
//
// Two regimes, picked by the wrapper from C (grouped_matmul.py::plan), each
// with the smallest tile that holds C (see dispatch):
// - decode (C <= 32), bound by the bytes of w: mma.sync.  One CTA per (tile
//   of 32 rows, 128 output columns, expert); at Grok-1's 8 rows per expert
//   24 rows are padding, and tensor-core work is free here while bytes are
//   not.  64-deep slices of x and w stream through a 4-stage cp.async ring
//   (16-byte copies, zero-filled past the edges of C, d and f): about 50 KB
//   of w in flight per CTA, two CTAs per SM.  The same kernel with a
//   64-row tile takes 33 to 64 rows (Kimi-K2's prefill chunk of 3 or 4
//   rows of 512 tokens), still bound by bytes there.  ldmatrix
//   feeds mma.sync.m16n8k16 (bf16 in, f32 accumulators in registers), w
//   through ldmatrix.trans.  Rows of the shared buffers are padded
//   by 16 bytes so that the eight rows one ldmatrix reads fall in distinct
//   banks.  When the grid would leave the SMs short of CTAs (Grok-1's down
//   projection: 384 CTAs over d = 32768), d is split into `split` ranges
//   of `chunk`; each CTA writes its f32 partial sums to scratch, and a
//   second kernel adds the partials in a fixed order (no atomics, so the
//   result is deterministic) and rounds once to bf16.
// - prefill (C > 64), bound by operations: wgmma, transposed (see
//   gmm_wgmma_t_kernel).  Designs with several row tiles per column tile
//   (on mma.sync or wgmma) were set by their copies, not their products:
//   each row tile read w from device memory, whatever their order in the
//   grid or a cluster launch.  One CTA now covers 160 rows (one n160 half,
//   C <= 160: Grok-1's chunk of one row of 512 tokens) or 320 (two halves:
//   Grok-1's chunk of two rows), and reads w once.
//
// Operands are read through strides (element strides of the expert and row
// axes; the last axis must be contiguous).  VEC = 1 copies with cp.async and
// needs every row 16-byte aligned; with VEC = 0 (rows not 16-byte aligned)
// the same tiles are filled element by element with plain loads.  Ragged C, d
// and f are masked in the copies and the stores.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// the launches go on the caller's stream, nothing is allocated (the caller
// passes the split-K scratch), and the return value is the CUDA error of the
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// One 16-byte chunk (8 elements) of a row into shared memory: the first n of
// them from src (n <= 0: none), the rest 0.  `base` is any valid address,
// given to cp.async when nothing is read.
template <bool VEC>
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src,
                                           const bf16* base, int n) {
  n = n < 0 ? 0 : n > 8 ? 8 : n;
  if constexpr (VEC) {
    cp_async16(dst, n > 0 ? src : base, 2 * n);
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    uint32_t t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = j < n ? s[j] : 0u;   // bf16 bits
    *reinterpret_cast<uint4*>(dst) = make_uint4(
        t[0] | (t[1] << 16), t[2] | (t[3] << 16), t[4] | (t[5] << 16),
        t[6] | (t[7] << 16));
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES>
struct Tile {
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int kWM = BM / WARPS_M;      // rows per warp
  static constexpr int kWN = BN / WARPS_N;      // columns per warp
  static constexpr int kMT = kWM / 16;          // m16 tiles per warp
  static constexpr int kNT = kWN / 8;           // n8 tiles per warp
  static constexpr int kLdA = BK + 8;           // padded row, elements
  static constexpr int kLdB = BN + 8;
  static constexpr int kAElems = BM * kLdA;
  static constexpr int kBElems = BK * kLdB;
  static constexpr size_t kSmem =
      static_cast<size_t>(STAGES) * (kAElems + kBElems) * sizeof(bf16);
  static_assert(kWM % 16 == 0 && kNT % 2 == 0 && BK % 16 == 0, "bad tile");
  static_assert(BK % 8 == 0 && BN % 8 == 0, "tiles are whole chunks");
};

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          bool VEC>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 2)
gmm_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              bf16* __restrict__ o, float* __restrict__ part, int E, int C,
              int d, int f, int chunk, long long sxe, long long sxc,
              long long swe, long long swd, long long soe, long long soc) {
  using TL = Tile<BM, BN, BK, WARPS_M, WARPS_N, STAGES>;
  constexpr int kThreads = TL::kThreads;
  constexpr int MT = TL::kMT, NT = TL::kNT;
  constexpr int LDA = TL::kLdA, LDB = TL::kLdB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);    // [STAGES][BM][LDA]
  bf16* Bs = As + STAGES * TL::kAElems;            // [STAGES][BK][LDB]

  const int n_mt = (C + BM - 1) / BM;
  const int mt = blockIdx.x % n_mt;
  const int s = blockIdx.x / n_mt;                 // split of d
  const int m0 = mt * BM;
  const int n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int k_begin = s * chunk;
  const int k_end = min(d, k_begin + chunk);
  const bf16* xe = x + e * sxe;
  const bf16* we = w + e * swe;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  // The slices of x and w at depth k0 into ring buffer `stage`.
  auto load_stage = [&](int stage, int k0) {
    bf16* a = As + stage * TL::kAElems;
    bf16* b = Bs + stage * TL::kBElems;
    constexpr int kAPerRow = BK / 8;
    for (int c = tid; c < BM * kAPerRow; c += kThreads) {
      const int r = c / kAPerRow;
      const int kc = (c - r * kAPerRow) * 8;
      const int row = m0 + r;
      load_chunk<VEC>(a + r * LDA + kc, xe + row * sxc + k0 + kc, x,
                      row < C ? k_end - (k0 + kc) : 0);
    }
    constexpr int kBPerRow = BN / 8;
    for (int c = tid; c < BK * kBPerRow; c += kThreads) {
      const int r = c / kBPerRow;
      const int nc = (c - r * kBPerRow) * 8;
      const int krow = k0 + r;
      load_chunk<VEC>(b + r * LDB + nc, we + krow * swd + n0 + nc, w,
                      krow < k_end ? f - (n0 + nc) : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int nk = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st, k_begin + st * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();     // slice kt has landed
    __syncthreads();                 // and every warp is done with kt - 1
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, k_begin + next * BK);
    cp_async_commit();
    const bf16* a = As + (kt % STAGES) * TL::kAElems;
    const bf16* b = Bs + (kt % STAGES) * TL::kBElems;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], a + (wm * TL::kWM + i * 16 + (lane % 16)) * LDA
                               + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bfr[4];   // b0, b1 of n-tile j, then of n-tile j + 1
        ldmatrix_x4_trans(
            bfr, b + (kk + (lane % 8) + ((lane / 8) % 2) * 8) * LDB
                     + wn * TL::kWN + j * 8 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16_16816(acc[i][j], af[i], bfr);
          mma_bf16_16816(acc[i][j + 1], af[i], bfr + 2);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Thread (lane) holds rows lane/4 and lane/4 + 8 of each m16 tile, columns
  // 2 (lane % 4) and + 1 of each n8 tile.
  const bool pair = part ? (f % 2 == 0) : (soc % 2 == 0 && soe % 2 == 0);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * TL::kWM + i * 16 + lane / 4 + 8 * hh;
      if (row >= C) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * TL::kWN + j * 8 + (lane % 4) * 2;
        const float v0 = acc[i][j][2 * hh];
        const float v1 = acc[i][j][2 * hh + 1];
        if (col >= f) continue;
        if (part) {
          float* p = part + ((static_cast<long long>(s) * E + e) * C + row)
                                * f + col;
          if (pair && col + 1 < f) {
            *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
          } else {
            p[0] = v0;
            if (col + 1 < f) p[1] = v1;
          }
        } else {
          bf16* p = o + e * soe + row * soc + col;
          if (pair && col + 1 < f) {
            *reinterpret_cast<__nv_bfloat162*>(p) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            p[0] = __float2bfloat16_rn(v0);
            if (col + 1 < f) p[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// The prefill regime, transposed: o^T = w^T x^T, so that one CTA covers all
// of a row tile's BT = 160 NH tokens and reads each slice of w from device
// memory once.  Two warpgroups each own 64 of the CTA's 128 output columns
// (the M of wgmma, w^T read M-major from w's rows) against the BT tokens
// (N, as NH n160 halves, x read K-major).  Slices 64 deep (one 128-byte
// line of bf16) stream through a STAGES-deep cp.async ring in the 128-byte
// swizzled layout, wgmma's conflict-free one: x as 128-byte lines, one per
// token, w in atoms of 8 rows of d x 64 columns; in both, 16-byte chunk c
// of line r sits at c ^ (r % 8).  Loads run two slices ahead of the slice
// being multiplied, and one slice of wgmma stays in flight while the next
// is issued.  The epilogue stores o element by element (o^T's fragments
// hold 2-byte runs of o).
template <int NH, int STAGES, bool VEC>
__global__ void __launch_bounds__(256, 1)
gmm_wgmma_t_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   bf16* __restrict__ o, int C, int d, int f, long long sxe,
                   long long sxc, long long swe, long long swd,
                   long long soe, long long soc) {
  constexpr int BF = 128, BT = 160 * NH, BK = 64;
  constexpr int kThreads = 256;
  constexpr int kWElems = BK * BF;
  constexpr int kXElems = BT * BK;
  constexpr int kNH = 80;               // f32 accumulators per n160 half
  // w^T (M-major): 64-column atoms 1024 bytes apart, 8-row groups of d
  // BF * 16 apart.  x (K-major): 8-token groups 1024 apart.
  constexpr uint32_t kWLbo = 1024, kWSbo = BF * 16;
  constexpr uint32_t kXLbo = 16, kXSbo = 1024;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ws = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* Xs = Ws + STAGES * kWElems;

  const int t0 = blockIdx.x * BT;
  const int f0 = blockIdx.y * BF;
  const int e = blockIdx.z;
  const bf16* xe = x + e * sxe;
  const bf16* we = w + e * swe;
  const int tid = threadIdx.x;
  const int wg = tid / 128;             // output columns f0 + 64 wg .. + 63

  auto load_stage = [&](int stage, int k0) {
    bf16* ws = Ws + stage * kWElems;
    bf16* xs = Xs + stage * kXElems;
    for (int c = tid; c < BK * (BF / 8); c += kThreads) {
      const int kr = c / (BF / 8);
      const int nc = c % (BF / 8);
      load_chunk<VEC>(ws + (kr / 8) * (8 * BF) + (nc / 8) * 512
                          + (kr % 8) * 64 + ((nc % 8) ^ (kr % 8)) * 8,
                      we + (k0 + kr) * swd + f0 + nc * 8, w,
                      k0 + kr < d ? f - (f0 + nc * 8) : 0);
    }
    for (int c = tid; c < BT * 8; c += kThreads) {
      const int r = c / 8;
      const int kc = c % 8;
      const int row = t0 + r;
      load_chunk<VEC>(xs + r * 64 + ((kc ^ (r % 8)) * 8),
                      xe + row * sxc + k0 + kc * 8, x,
                      row < C ? d - (k0 + kc * 8) : 0);
    }
  };

  float acc[NH][kNH];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < kNH; ++i) acc[h][i] = 0.f;

  const int nk = (d + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 2; ++st) {
    if (st < nk) load_stage(st, st * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 3>();       // slice kt has landed
    fence_proxy_async();
    __syncthreads();                   // and slice kt - 2's wgmma are done
    const int next = kt + STAGES - 2;
    if (next < nk) load_stage(next % STAGES, next * BK);
    cp_async_commit();
    const bf16* ws = Ws + (kt % STAGES) * kWElems + wg * 512;
    const bf16* xs = Xs + (kt % STAGES) * kXElems;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < kNH; ++i) fence_operand(acc[h][i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t da = smem_desc(ws + ks * 2 * 8 * BF, kWLbo, kWSbo);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint64_t db =
            smem_desc(xs + h * 160 * 64 + ks * 16, kXLbo, kXSbo);
        wgmma_m64n160k16_ta(acc[h], da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();                   // slice kt - 1's are done
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < kNH; ++i) fence_operand(acc[h][i]);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < kNH; ++i) fence_operand(acc[h][i]);

  // Warp v of warpgroup wg holds output columns f0 + 64 wg + 16 v + lane/4
  // (+ 8) and, in each n8 block j of half h, tokens 160 h + 8 j +
  // 2 (lane % 4) and + 1.
  const int lane = tid % 32;
  const int col0 = f0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
  bf16* oe = o + e * soe;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int j = 0; j < kNH / 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int col = col0 + (r / 2) * 8;
        const int tok = t0 + h * 160 + j * 8 + (lane % 4) * 2 + r % 2;
        if (col < f && tok < C)
          oe[tok * soc + col] = __float2bfloat16_rn(acc[h][j * 4 + r]);
      }
    }
  }
}

template <int NH, int STAGES, bool VEC>
int launch_wgmma_t(const void* x, const void* w, void* o, int E, int C,
                   int d, int f, const long long* st, cudaStream_t stream) {
  constexpr int BT = 160 * NH;
  constexpr size_t smem =          // the ring, and room to align it
      static_cast<size_t>(STAGES) * (64 * 128 + BT * 64) * sizeof(bf16)
      + 1024;
  auto kernel = gmm_wgmma_t_kernel<NH, STAGES, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + BT - 1) / BT, (f + 127) / 128, E);
  kernel<<<grid, 256, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(o), C, d, f, st[0], st[1], st[2], st[3], st[4],
      st[5]);
  return static_cast<int>(cudaGetLastError());
}

// Split-K's second pass: o[e, c, j] = sum over s in order of part[s, e, c, j],
// rounded once to bf16.
__global__ void __launch_bounds__(256)
splitk_sum_kernel(const float* __restrict__ part, bf16* __restrict__ o,
                  int split, int C, int f, long long n, long long soe,
                  long long soc) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += 256LL * gridDim.x) {
    float acc = 0.f;
    for (int s = 0; s < split; ++s) acc += part[s * n + i];
    const long long ec = i / f;
    const int col = static_cast<int>(i - ec * f);
    const int e = static_cast<int>(ec / C);
    const int row = static_cast<int>(ec - static_cast<long long>(e) * C);
    o[e * soe + row * soc + col] = __float2bfloat16_rn(acc);
  }
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          bool VEC>
int launch(const void* x, const void* w, void* o, void* part, int E, int C,
           int d, int f, int split, int chunk, const long long* st,
           cudaStream_t stream) {
  using TL = Tile<BM, BN, BK, WARPS_M, WARPS_N, STAGES>;
  auto kernel =
      gmm_tc_kernel<BM, BN, BK, WARPS_M, WARPS_N, STAGES, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(TL::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((C + BM - 1) / BM) * split, (f + BN - 1) / BN, E);
  float* p = split > 1 ? static_cast<float*>(part) : nullptr;
  kernel<<<grid, TL::kThreads, TL::kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(o), p, E, C, d, f, split > 1 ? chunk : d, st[0],
      st[1], st[2], st[3], st[4], st[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(E) * C * f;
  const long long blocks = (n + 255) / 256;
  splitk_sum_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256,
                      0, stream>>>(p, static_cast<bf16*>(o), split, C, f, n,
                                   st[4], st[5]);
  return static_cast<int>(cudaGetLastError());
}

// Variants, by the wrapper's plan (grouped_matmul.py::TC_VARIANTS); a call
// takes the first whose rows hold C, else the last:
// 0: 32 x 128 x 64 on mma.sync, 4 warps of 32 x 32, 4 stages (decode);
// 1: 64 x 128 x 64 on mma.sync, 8 warps of 32 x 32, 4 stages (prefill);
// 2: 160 rows x 128 x 64 on wgmma, 2 warpgroups, 4 stages (prefill);
// 3: 320 rows x 128 x 64 on wgmma, 2 warpgroups, 4 stages (prefill).
template <bool VEC>
int dispatch(const void* x, const void* w, void* o, void* part, int E, int C,
             int d, int f, int variant, int split, int chunk,
             const long long* st, cudaStream_t s) {
  if (variant >= 2 && split != 1)       // the wgmma kernel does not split
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0:
      return launch<32, 128, 64, 1, 4, 4, VEC>(x, w, o, part, E, C, d, f,
                                               split, chunk, st, s);
    case 1:
      return launch<64, 128, 64, 2, 4, 4, VEC>(x, w, o, part, E, C, d, f,
                                               split, chunk, st, s);
    case 2:
      return launch_wgmma_t<1, 4, VEC>(x, w, o, E, C, d, f, st, s);
    case 3:
      return launch_wgmma_t<2, 4, VEC>(x, w, o, E, C, d, f, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 6 element strides, (expert, row) for x, w and o in turn; the last
// axis of each is contiguous.  variant picks the tile (see dispatch); vec = 1
// needs every row of x and w 16-byte aligned.  split > 1 splits d into
// ranges of `chunk` (a multiple of the tile's depth) and needs `part`, f32
// scratch of split * E * C * f floats (mma.sync variants only).
extern "C" int grouped_matmul_bf16_fwd(const void* x, const void* w, void* o,
                                       void* part, int E, int C, int d, int f,
                                       const long long* strides, int variant,
                                       int vec, int split, int chunk,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split < 1 || (split > 1 && (part == nullptr || chunk < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec)
    return dispatch<true>(x, w, o, part, E, C, d, f, variant, split, chunk,
                          strides, s);
  return dispatch<false>(x, w, o, part, E, C, d, f, variant, split, chunk,
                         strides, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
