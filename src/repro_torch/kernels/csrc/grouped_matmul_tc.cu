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
// - prefill (C > 64), bound by operations (and, narrowly, by the bytes of
//   w): wgmma, transposed and warp-specialised (see gmm_tma_kernel).
//   Designs with several row tiles per column tile were set by their
//   copies, not their products: each row tile read w from device memory.
//   One CTA covers 160 rows (C <= 160: Grok-1's chunk of one row of 512
//   tokens) or 320 (Grok-1's chunk of two rows) and reads w once.  The
//   kernel it replaced (the same tiles, its 256 threads issuing cp.async
//   copies two slices ahead, 2-byte stores) reached 0.37 of its bound at
//   (8, 320, 6144, 32768): every CTA read its expert's whole x through L2
//   (about 8 GB a call against 3.2 GB of w), and no thread was free to
//   copy.  Now a TMA producer warpgroup keeps a 4- or 6-slot ring full,
//   clusters of CTAs along f share each slice of x by multicast, and the
//   epilogue stores 16 bytes a thread.
//
// Operands are read through strides (element strides of the expert and row
// axes; the last axis must be contiguous).  mma.sync: VEC = 1 copies with
// cp.async and needs every row 16-byte aligned; with VEC = 0 (rows not
// 16-byte aligned) the same tiles are filled element by element with plain
// loads.  wgmma: TMA tensor maps, whose dimensions, byte strides and boxes
// the wrapper computes (grouped_matmul.tma_layout); rows that TMA cannot
// describe (a base or a stride not 16-byte aligned, as at (1, 77, 24, 129))
// go to the mma.sync kernel's 64-row tile instead (grouped_matmul.plan).
// Ragged C, d and f are masked in the copies (TMA: zero fill) and the
// stores.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// the launches go on the caller's stream, nothing is allocated (the caller
// passes the split-K scratch), and the return value is the CUDA error of the
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "tma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMapWords = 8;            // a 3-d map: 3 dims, 2 strides, 3 box
// CTAs per cluster on wgmma (grouped_matmul.CLUSTER): 4 was slower than 2
// at Grok-1's prefill shapes on the H100 (tools/torch_kernel_check.py).
constexpr int kCluster = 2;

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

// The prefill regime, transposed and warp-specialised: o^T = w^T x^T, so
// that one CTA covers all of a row tile's BT = 160 NH tokens (N of wgmma, x
// read K-major) against 128 output columns (M, two warpgroups of 64, w^T
// read M-major from w's rows), and reads each slice of w from device
// memory once.
// - Warpgroup 0 is the producer: it gives up registers (setmaxnreg) and one
//   thread streams 64-deep slices of w (two 64-column boxes) and x through
//   a STAGES-deep TMA ring, each slot with a full and an empty mbarrier.
// - The CTAs of a cluster of CS along f share their token tile: each loads
//   BT / CS of the slice's token rows and multicasts them to every CTA of
//   the cluster, so x crosses L2 once per cluster, not once per CTA.  A
//   slot is free again once both consumer warpgroups of every CTA of the
//   cluster have released it (remote arrives on the empty barriers), and
//   the producer waits for the last releases before it exits, so no CTA
//   leaves while a peer may still signal it.
// - Warpgroups 1 and 2 are consumers with 232 registers: per slice four
//   k16 steps of wgmma_m64n160k16_ta per 160 tokens, one slice's products
//   in flight while the next is issued.
// - The epilogue stages the tile through shared memory as o's rows
//   (stmatrix.trans turns o^T's fragments into 16-byte runs of o; rows
//   padded to 272 bytes, so the eight rows one stmatrix writes fall in
//   distinct banks) and stores 16 bytes a thread, coalesced.
// Rows and columns past C, d and f arrive as zeros and are not stored.
template <int NH, int STAGES, int CS>
struct TmaTile {
  static constexpr int kBF = 128, kBT = 160 * NH, kBK = 64;
  static constexpr int kWBytes = kBK * kBF * 2;      // two 64-column boxes
  static constexpr int kXBytes = kBT * kBK * 2;      // kBT rows of 128 bytes
  static constexpr int kXPart = kBT / CS;            // rows each CTA loads
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kOLd = kBF + 8;               // staged row, elements
  static constexpr int kSmem = STAGES * kStageBytes + 2 * STAGES * 8 + 1024;
  static_assert(kBT * kOLd * 2 <= STAGES * kStageBytes, "staging fits");
  static_assert(kSmem <= 232448, "shared memory");
  static_assert((kXPart * 128) % 1024 == 0, "parts keep swizzle atoms");
};

template <int NH, int STAGES, int CS>
__global__ void __launch_bounds__(384, 1)
gmm_tma_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               bf16* __restrict__ o, int C, int d, int f, long long soe,
               long long soc, int vec_out) {
  using TT = TmaTile<NH, STAGES, CS>;
  constexpr int BF = TT::kBF, BT = TT::kBT, BK = TT::kBK;
  constexpr int kNH = 80;               // f32 accumulators per n160 half
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES *
                                               TT::kStageBytes);
  uint64_t* empty = full + STAGES;

  const int f0 = blockIdx.x * BF;
  const int t0 = blockIdx.y * BT;
  const int e = blockIdx.z;
  const int nk = (d + BK - 1) / BK;
  const uint32_t rank = cluster_rank();

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2 * CS);     // both consumers of every CTA
    }
    fence_mbar_init();
  }
  __syncthreads();
  cluster_sync();                       // every peer's barriers are ready

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        unsigned char* st = smem + s * TT::kStageBytes;
        mbar_wait(empty + s, ((kt / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, TT::kStageBytes);
        tma_load_3d(st, &wmap, full + s, f0, kt * BK, e);
        tma_load_3d(st + TT::kWBytes / 2, &wmap, full + s, f0 + 64, kt * BK,
                    e);
        tma_load_3d_multicast(st + TT::kWBytes + rank * TT::kXPart * 128,
                              &xmap, full + s,
                              static_cast<uint16_t>((1 << CS) - 1), kt * BK,
                              t0 + rank * TT::kXPart, e);
      }
      // The last releases of every slot: after them no peer signals this
      // CTA's barriers or writes its shared memory.
      for (int kt = nk; kt < nk + STAGES; ++kt)
        mbar_wait(empty + kt % STAGES, ((kt / STAGES) & 1) ^ 1);
    }
    return;
  }

  // Consumers: warpgroup g computes output columns f0 + 64 g .. + 63.
  setmaxnreg_inc<232>();
  const int g = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  float acc[NH][kNH];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < kNH; ++i) acc[h][i] = 0.f;

  // Release slot s of this round in every CTA of the cluster: lane r of
  // the warpgroup's first warp arrives at CTA r.
  auto release = [&](int s) {
    if (tid < CS) mbar_arrive_cluster(empty + s, tid);
  };
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + s, (kt / STAGES) & 1);
    const unsigned char* st = smem + s * TT::kStageBytes;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < kNH; ++i) fence_operand(acc[h][i]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // w^T, M-major: one 64-column box, its 8-row groups of d 1024 apart.
      const uint64_t da =
          smem_desc(st + g * (TT::kWBytes / 2) + ks * 2048, 1024, 1024);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const uint64_t db = smem_desc(
            st + TT::kWBytes + h * 160 * 128 + ks * 32, 16, 1024);
        wgmma_m64n160k16_ta(acc[h], da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();                    // slice kt - 1's products are done
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < kNH; ++i) fence_operand(acc[h][i]);
    if (kt > 0) release((kt - 1) % STAGES);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < kNH; ++i) fence_operand(acc[h][i]);
  release((nk - 1) % STAGES);

  // Epilogue: both consumer warpgroups are done with the ring before it
  // holds the output tile.  Warp v of warpgroup g holds output columns
  // 64 g + 16 v + lane/4 (+ 8) and, in each n8 block j of half h, tokens
  // 160 h + 8 j + 2 (lane % 4) and + 1: per pair of n8 blocks, four 8x8
  // matrices (columns + 0 and + 8, blocks j and j + 1), stored transposed.
  bar_sync(1, 256);
  bf16* os = reinterpret_cast<bf16*>(smem);       // [BT][kOLd]
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int mi = lane / 8;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int j = 0; j < kNH / 4; j += 2) {
      const int tok = h * 160 + (j + mi / 2) * 8 + lane % 8;
      const int col = 64 * g + 16 * warp + 8 * (mi % 2);
      stmatrix_x4_trans(os + tok * TT::kOLd + col,
                        pack_bf16x2(acc[h][4 * j], acc[h][4 * j + 1]),
                        pack_bf16x2(acc[h][4 * j + 2], acc[h][4 * j + 3]),
                        pack_bf16x2(acc[h][4 * j + 4], acc[h][4 * j + 5]),
                        pack_bf16x2(acc[h][4 * j + 6], acc[h][4 * j + 7]));
    }
  }
  bar_sync(1, 256);
  bf16* oe = o + e * soe;
  for (int c = threadIdx.x - 128; c < BT * (BF / 8); c += 256) {
    const int tok = c / (BF / 8);
    const int ch = c % (BF / 8);
    const int row = t0 + tok;
    const int col = f0 + ch * 8;
    if (row >= C || col >= f) continue;
    const bf16* src = os + tok * TT::kOLd + ch * 8;
    bf16* dst = oe + row * soc + col;
    if (vec_out && col + 8 <= f) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < 8 && col + i < f; ++i) dst[i] = src[i];
    }
  }
}

// xl, wl: 3-d tensor maps of kMapWords each (grouped_matmul.tma_layout):
// x's dims (d, C, E) with box (64, BT / CS, 1), w's (f, d, E) with box
// (64, 64, 1).  The grid's column tiles are rounded up to whole clusters;
// a CTA past f loads zeros and stores nothing.
template <int NH, int STAGES, int CS>
int launch_tma(const void* x, const void* w, void* o, int E, int C, int d,
               int f, const long long* xl, const long long* wl,
               long long soe, long long soc, int vec_out,
               cudaStream_t stream) {
  using TT = TmaTile<NH, STAGES, CS>;
  CUtensorMap xm, wm;
  int err = encode_bf16_map(&xm, x, 3, xl);
  if (err == 0) err = encode_bf16_map(&wm, w, 3, wl);
  if (err != 0) return err;
  auto kernel = gmm_tma_kernel<NH, STAGES, CS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TT::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int col_tiles = (f + TT::kBF - 1) / TT::kBF;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((col_tiles + CS - 1) / CS * CS,
                     (C + TT::kBT - 1) / TT::kBT, E);
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = TT::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, xm, wm, static_cast<bf16*>(o), C, d,
                         f, soe, soc, vec_out);
  if (e != cudaSuccess) return static_cast<int>(e);
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

// Variants, by the wrapper's plan (grouped_matmul.py::TC_VARIANTS): a call
// takes the first whose rows hold C, else the last; rows that TMA cannot
// read (a base or a stride of x or w not 16-byte aligned) take variant 1
// whatever C.
// 0: 32 x 128 x 64 on mma.sync, 4 warps of 32 x 32, 4 stages (decode);
// 1: 64 x 128 x 64 on mma.sync, 8 warps of 32 x 32, 4 stages (prefill);
// 2: 160 rows x 128 x 64 on wgmma, TMA, 3 warpgroups, 6 stages (prefill);
// 3: 320 rows x 128 x 64 on wgmma, TMA, 3 warpgroups, 4 stages (prefill).
template <bool VEC>
int dispatch(const void* x, const void* w, void* o, void* part, int E, int C,
             int d, int f, int variant, int split, int chunk,
             const long long* st, cudaStream_t s) {
  switch (variant) {
    case 0:
      return launch<32, 128, 64, 1, 4, 4, VEC>(x, w, o, part, E, C, d, f,
                                               split, chunk, st, s);
    case 1:
      return launch<64, 128, 64, 2, 4, 4, VEC>(x, w, o, part, E, C, d, f,
                                               split, chunk, st, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_tma(const void* x, const void* w, void* o, int E, int C, int d,
                 int f, int variant, int cluster, const long long* maps,
                 const long long* st, cudaStream_t s) {
  const long long* xl = maps;
  const long long* wl = maps + kMapWords;
  const int vec_out = st[4] % 8 == 0 && st[5] % 8 == 0
                      && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  if (cluster != kCluster) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 2:
      return launch_tma<1, 6, kCluster>(x, w, o, E, C, d, f, xl, wl, st[4],
                                        st[5], vec_out, s);
    case 3:
      return launch_tma<2, 4, kCluster>(x, w, o, E, C, d, f, xl, wl, st[4],
                                        st[5], vec_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 6 element strides, (expert, row) for x, w and o in turn; the last
// axis of each is contiguous.  variant picks the tile (see dispatch).
// Variants 0 and 1: vec = 1 needs every row of x and w 16-byte aligned;
// split > 1 splits d into ranges of `chunk` (a multiple of the tile's depth)
// and needs `part`, f32 scratch of split * E * C * f floats.  Variants 2 and
// 3: `maps` holds x's and w's tensor maps (kMapWords each), `cluster` is
// kCluster, and split must be 1.
extern "C" int grouped_matmul_bf16_fwd(const void* x, const void* w, void* o,
                                       void* part, int E, int C, int d, int f,
                                       const long long* strides, int variant,
                                       int vec, int split, int chunk,
                                       const long long* maps, int cluster,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split < 1 || (split > 1 && (part == nullptr || chunk < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant >= 2) {
    if (split != 1 || maps == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_tma(x, w, o, E, C, d, f, variant, cluster, maps, strides,
                        s);
  }
  if (vec)
    return dispatch<true>(x, w, o, part, E, C, d, f, variant, split, chunk,
                          strides, s);
  return dispatch<false>(x, w, o, part, E, C, d, f, variant, split, chunk,
                         strides, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
