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
// Three kernels, picked by the wrapper (grouped_matmul.py::plan):
// - small C (C <= 64 rows an expert: every decode step, Kimi-K2's prefill
//   chunks), bound by the bytes of w: gmm_stream_kernel, a persistent
//   warp-specialised TMA stream of w into narrow wgmma (see there).  The
//   design it replaced (mma.sync from a cp.async ring, one CTA per tile of
//   32 rows x 128 columns, split-K by a second pass) reached 0.85-0.89 of
//   the bytes bound, the stream 0.88-0.94 on the H100: its copies set the
//   time and a quarter of it went to work beside them
//   (tools/torch_kernel_ablate.py --sync-decode), as 2048 to 21,504 short
//   CTAs each filled and drained a ring of its own.
// - large C (C > 64), bound by operations (and, narrowly, by the bytes of
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
// - rows that TMA cannot describe (a base or a stride of x or w not 16-byte
//   aligned, as at (2, 1, 99, 37) and (1, 77, 24, 129)), any C:
//   gmm_tc_kernel, mma.sync on 64 x 128 tiles whose slices are filled
//   element by element with plain loads.
//
// Operands are read through strides (element strides of the expert and row
// axes; the last axis must be contiguous): the TMA kernels through tensor
// maps whose dimensions, byte strides and boxes the wrapper computes
// (grouped_matmul.tma_layout), gmm_tc_kernel through the strides
// themselves.  Ragged C, d and f are masked in the copies (TMA: zero fill)
// and the stores.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// the launches go on the caller's stream, nothing is allocated (the caller
// passes the small-C kernel's scratch), and the return value is the CUDA
// error of the launches.

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
constexpr int kSmemLimit = 232448;      // shared memory a block may use

// One 16-byte chunk (8 elements) of a row into shared memory, element by
// element: the first n of them from src (n <= 0: none), the rest 0.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src,
                                           int n) {
  n = n < 0 ? 0 : n > 8 ? 8 : n;
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  uint32_t t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = j < n ? s[j] : 0u;   // bf16 bits
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      t[0] | (t[1] << 16), t[2] | (t[3] << 16), t[4] | (t[5] << 16),
      t[6] | (t[7] << 16));
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

// Rows TMA cannot read: one CTA per (tile of BM rows, BN output columns,
// expert).  BK-deep slices of x and w are copied element by element into a
// STAGES-deep ring (rows padded by 16 bytes, so that the eight rows one
// ldmatrix reads fall in distinct banks); ldmatrix feeds
// mma.sync.m16n8k16, w through ldmatrix.trans.
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 2)
gmm_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              bf16* __restrict__ o, int C, int d, int f, long long sxe,
              long long sxc, long long swe, long long swd, long long soe,
              long long soc) {
  using TL = Tile<BM, BN, BK, WARPS_M, WARPS_N, STAGES>;
  constexpr int kThreads = TL::kThreads;
  constexpr int MT = TL::kMT, NT = TL::kNT;
  constexpr int LDA = TL::kLdA, LDB = TL::kLdB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);    // [STAGES][BM][LDA]
  bf16* Bs = As + STAGES * TL::kAElems;            // [STAGES][BK][LDB]

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
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
      load_chunk(a + r * LDA + kc, xe + row * sxc + k0 + kc,
                 row < C ? d - (k0 + kc) : 0);
    }
    constexpr int kBPerRow = BN / 8;
    for (int c = tid; c < BK * kBPerRow; c += kThreads) {
      const int r = c / kBPerRow;
      const int nc = (c - r * kBPerRow) * 8;
      const int krow = k0 + r;
      load_chunk(b + r * LDB + nc, we + krow * swd + n0 + nc,
                 krow < d ? f - (n0 + nc) : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int nk = (d + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st)
    if (st < nk) load_stage(st, st * BK);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();                 // slice kt is stored, kt - 1 is done
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, next * BK);
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

  // Thread (lane) holds rows lane/4 and lane/4 + 8 of each m16 tile, columns
  // 2 (lane % 4) and + 1 of each n8 tile.
  const bool pair = soc % 2 == 0 && soe % 2 == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = m0 + wm * TL::kWM + i * 16 + lane / 4 + 8 * hh;
      if (row >= C) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * TL::kWN + j * 8 + (lane % 4) * 2;
        if (col >= f) continue;
        bf16* p = o + e * soe + row * soc + col;
        const float v0 = acc[i][j][2 * hh];
        const float v1 = acc[i][j][2 * hh + 1];
        if (pair && col + 1 < f) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
        } else {
          p[0] = __float2bfloat16_rn(v0);
          if (col + 1 < f) p[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// The small-C regime, a persistent TMA stream of w.  At C <= 64 rows an
// expert a call reads each weight once and does 2 C flops on it (decode:
// 16), far below the card's 295 flops a byte: the time is the bytes of w,
// and the design is about keeping them moving.
// - Work: (expert, BF-column tile) items, each a sequence of `slices`
//   64-deep slices of d.  P persistent CTAs (grouped_matmul.stream_ctas:
//   one an SM, or down to 15/16 of the SMs where that many divide the
//   items) take the items in rounds, CTA c item r P + c of round r
//   (stream_walk), so that at any
//   time the CTAs stream neighbouring column tiles of one or two experts
//   at about the same depth: together they read whole runs of w's rows,
//   and each expert's x is read from device memory about once and then
//   from L2.  The items left after the last full round (fewer than P) are
//   cut into P equal ranges of slices, CTA c the units [c U / P, (c + 1)
//   U / P) of their U, so that every CTA streams the same number of
//   slices to within one and the last wave's tail is one slice, not one
//   item.  A cut item is computed in pieces (ranges of d): a piece stores
//   its f32 sums to the CTA's scratch slot (0 for its first piece, 1 for
//   its last) and gmm_stream_fold_kernel, a second launch queued behind
//   it (programmatic dependent launch), adds an item's pieces in CTA
//   order (no atomics: two launches give the same bits).  (Contiguous
//   ranges over all the items, the first build, kept every CTA on items
//   of its own: at Kimi-K2's 28 rows each re-read its experts' x from
//   device memory, 15% slower than the design it replaced.)
// - Warp 4 is the producer: one thread walks the CTA's pieces in order and
//   issues each slice's TMA loads (w: BF / 64 boxes of 64 rows x 64
//   columns; x: the slice's N token rows, rows past C zero-filled by the
//   map's bound on the row dimension) into a ring of `stages` slots
//   (grouped_matmul.STREAM_STAGES: 3 at BF = 256, 96 KB of w in flight an
//   SM; the 4 to 6 that shared memory holds timed no faster, and 1-4%
//   slower at N = 32: tools/torch_kernel_ablate.py), each with a full and
//   an empty mbarrier.  The slot count
//   runs on across items, so the next item's first slices load while this
//   one's last are multiplied and stored: the stream does not drain
//   between items.
// - Warps 0-3, one warpgroup, consume: o^T = w^T x^T, per slice four k16
//   steps of wgmma m64nNk16 per 64 output columns (w^T M-major from w's
//   rows, x^T K-major), N = C rounded up to 8, 16, 32 or 64, so that at
//   decode no token row past 8 is computed; one slice's products in flight
//   while the next is issued.  At an item's end the warpgroup stages its
//   bf16 tile in shared memory outside the ring (which the producer is
//   already refilling) and stores 16 bytes a thread; a piece's f32 sums go
//   to scratch transposed, 8 bytes a thread.
template <int N, int NT>
struct StreamTile {
  static constexpr int kBF = 64 * NT;                // output columns
  static constexpr int kWBytes = 64 * kBF * 2;       // NT boxes of 8 KB
  static constexpr int kXBytes = N * 128;            // N rows of 128 bytes
  static constexpr int kSlot = kWBytes + kXBytes;
  static constexpr int kOLd = kBF + 8;               // staged row, elements
  static constexpr int kStage = N * kOLd * 2;
  // grouped_matmul.stream_smem_bytes: 1024 to align the base, the ring, the
  // staged tile, a full and an empty mbarrier a slot.
  static constexpr int smem(int stages) {
    return 1024 + stages * (kSlot + 16) + kStage;
  }
  static_assert(kXBytes % 1024 == 0, "slots keep swizzle atoms");
};
constexpr int kStreamThreads = 160;     // a consumer warpgroup, a producer

// CTA `cta` of `ctas`: its whole items in rounds, then its range of the
// rest, as body(item, first slice, end slice, scratch slot or -1 for a
// whole item) (grouped_matmul.stream_pieces).
template <typename Body>
__device__ __forceinline__ void stream_walk(int cta, int ctas, int items,
                                            int slices, Body&& body) {
  const int rounds = items / ctas;
  const int first = rounds * ctas;
  const long long rest = static_cast<long long>(items - first) * slices;
  for (int r = 0; r < rounds; ++r) body(r * ctas + cta, 0, slices, -1);
  const long long lo = static_cast<long long>(cta) * rest / ctas;
  const long long hi = (static_cast<long long>(cta) + 1) * rest / ctas;
  for (long long u = lo; u < hi;) {
    const int item = static_cast<int>(u / slices);
    const int s0 = static_cast<int>(u - static_cast<long long>(item)
                                    * slices);
    const int s1 = static_cast<int>(
        min(static_cast<long long>(slices), s0 + (hi - u)));
    body(first + item, s0, s1,
         s0 == 0 && s1 == slices ? -1 : (u == lo ? 0 : 1));
    u += s1 - s0;
  }
}

template <int N, int NT>
__global__ void __launch_bounds__(kStreamThreads, 1)
gmm_stream_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  bf16* __restrict__ o, float* __restrict__ part, int C,
                  int f, int col_tiles, int slices, int items, int stages,
                  long long soe, long long soc, int vec_out) {
  using ST = StreamTile<N, NT>;
  constexpr int BF = ST::kBF;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* os = reinterpret_cast<bf16*>(smem + stages * ST::kSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * ST::kSlot
                                               + ST::kStage);
  uint64_t* empty = full + stages;
  const int cta = blockIdx.x, ctas = gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    fence_mbar_init();
  }
  __syncthreads();
  launch_dependents();                  // the fold may be scheduled now

  if (threadIdx.x >= 128) {
    // Producer: slot it % stages in round it / stages, counted across items.
    if (threadIdx.x == 128) {
      int it = 0;
      stream_walk(cta, ctas, items, slices,
                  [&](int item, int s0, int s1, int) {
        const int e = item / col_tiles;
        const int f0 = (item - e * col_tiles) * BF;
        for (int s = s0; s < s1; ++s, ++it) {
          const int slot = it % stages;
          unsigned char* st = smem + slot * ST::kSlot;
          mbar_wait(empty + slot, ((it / stages) & 1) ^ 1);
          mbar_expect_tx(full + slot, ST::kSlot);
#pragma unroll
          for (int p = 0; p < NT; ++p)
            tma_load_3d(st + p * 8192, &wmap, full + slot, f0 + 64 * p,
                        64 * s, e);
          tma_load_3d(st + ST::kWBytes, &xmap, full + slot, 64 * s, 0, e);
        }
      });
    }
    return;
  }

  // Consumers.  Warp v holds output columns 64 p + 16 v + lane / 4 (and
  // + 8) of each panel p and, in n8 block j, tokens 8 j + 2 (lane % 4) and
  // + 1.
  const int tid = threadIdx.x;
  const int col = 16 * (tid / 32) + (tid % 32) / 4;
  const int tok = 2 * (tid % 4);
  float acc[NT][N / 2];
  int it = 0;
  stream_walk(cta, ctas, items, slices,
              [&](int item, int s0, int s1, int piece) {
#pragma unroll
    for (int p = 0; p < NT; ++p)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[p][i] = 0.f;
    for (int s = s0; s < s1; ++s, ++it) {
      const int slot = it % stages;
      mbar_wait(full + slot, (it / stages) & 1);
      const unsigned char* st = smem + slot * ST::kSlot;
#pragma unroll
      for (int p = 0; p < NT; ++p)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) fence_operand(acc[p][i]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t db = smem_desc(st + ST::kWBytes + ks * 32, 16, 1024);
#pragma unroll
        for (int p = 0; p < NT; ++p)
          wgmma_m64nNk16_ta<N>(
              acc[p], smem_desc(st + p * 8192 + ks * 2048, 1024, 1024), db);
      }
      wgmma_commit();
      wgmma_wait<1>();                  // slice s - 1's products are done
#pragma unroll
      for (int p = 0; p < NT; ++p)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) fence_operand(acc[p][i]);
      if (s > s0 && tid == 0) mbar_arrive(empty + (it - 1) % stages);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NT; ++p)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) fence_operand(acc[p][i]);
    if (tid == 0) mbar_arrive(empty + (it - 1) % stages);

    const int e = item / col_tiles;
    const int f0 = (item - e * col_tiles) * BF;
    if (piece < 0) {
      // The whole item: bf16 through the staged tile into o.
      bar_sync(1, 128);                 // the last tile's stores are done
#pragma unroll
      for (int p = 0; p < NT; ++p)
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          bf16* r = os + (8 * j + tok) * ST::kOLd + 64 * p + col;
          r[0] = __float2bfloat16_rn(acc[p][4 * j]);
          r[ST::kOLd] = __float2bfloat16_rn(acc[p][4 * j + 1]);
          r[8] = __float2bfloat16_rn(acc[p][4 * j + 2]);
          r[ST::kOLd + 8] = __float2bfloat16_rn(acc[p][4 * j + 3]);
        }
      bar_sync(1, 128);
      bf16* oe = o + e * soe;
      for (int c = tid; c < C * (BF / 8); c += 128) {
        const int row = c / (BF / 8);
        const int cc = f0 + (c % (BF / 8)) * 8;
        if (cc >= f) continue;
        const bf16* src = os + row * ST::kOLd + (cc - f0);
        bf16* dst = oe + row * soc + cc;
        if (vec_out && cc + 8 <= f) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int i = 0; i < 8 && cc + i < f; ++i) dst[i] = src[i];
        }
      }
    } else {
      // A piece: its f32 sums, as o^T (BF columns of N tokens), to its
      // slot of the scratch.
      float* pp = part + (static_cast<long long>(cta) * 2 + piece) * BF * N;
#pragma unroll
      for (int p = 0; p < NT; ++p)
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          float* r = pp + (64 * p + col) * N + 8 * j + tok;
          *reinterpret_cast<float2*>(r) =
              make_float2(acc[p][4 * j], acc[p][4 * j + 1]);
          *reinterpret_cast<float2*>(r + 8 * N) =
              make_float2(acc[p][4 * j + 2], acc[p][4 * j + 3]);
        }
    }
  });
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


// The small-C kernel's second pass: each item that a CTA's range cut, its
// pieces' f32 sums added in CTA order and rounded once to bf16, 16 bytes a
// thread into o.  Block b looks at the start of CTA c = b + 1's range of
// the items left after the rounds: when it falls inside an item whose
// first piece is CTA c - 1's, the block folds that item; every other
// block returns at once.
__global__ void __launch_bounds__(256)
gmm_stream_fold_kernel(const float* __restrict__ part, bf16* __restrict__ o,
                       int C, int N, int BF, int f, int col_tiles,
                       int slices, int items, long long soe, long long soc,
                       int vec_out) {
  grid_dependency_wait();               // every piece is stored
  const int ctas = gridDim.x + 1;
  const int c = blockIdx.x + 1;
  const int first = items / ctas * ctas;
  const long long rest = static_cast<long long>(items - first) * slices;
  auto lo_of = [&](int cc) {
    return static_cast<long long>(cc) * rest / ctas;
  };
  const long long lo = lo_of(c);
  const long long item = lo / slices;
  const long long start = item * slices;
  const long long end = start + slices;
  if (lo == start || lo_of(c - 1) > start) return;
  const int e = static_cast<int>((first + item) / col_tiles);
  const int f0 = static_cast<int>(first + item - static_cast<long long>(e)
                                  * col_tiles) * BF;
  for (int i = threadIdx.x; i < C * (BF / 8); i += 256) {
    const int row = i / (BF / 8);
    const int m = (i % (BF / 8)) * 8;
    if (f0 + m >= f) continue;
    float s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = 0.f;
    for (int cc = c - 1; cc < ctas && lo_of(cc) < end; ++cc) {
      if (lo_of(cc + 1) == lo_of(cc)) continue;     // an empty range
      const int slot = lo_of(cc) / slices == item ? 0 : 1;
      const float* pp = part + (static_cast<long long>(cc) * 2 + slot)
                                   * BF * N + static_cast<long long>(m) * N
                        + row;
#pragma unroll
      for (int k = 0; k < 8; ++k) s[k] += pp[k * N];
    }
    bf16* dst = o + e * soe + row * soc + f0 + m;
    if (vec_out && f0 + m + 8 <= f) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(
          pack_bf16x2(s[0], s[1]), pack_bf16x2(s[2], s[3]),
          pack_bf16x2(s[4], s[5]), pack_bf16x2(s[6], s[7]));
    } else {
      for (int k = 0; k < 8 && f0 + m + k < f; ++k)
        dst[k] = __float2bfloat16_rn(s[k]);
    }
  }
}

// Whether some CTA's range of the items left after the rounds starts
// inside an item, so that the call needs the scratch and the fold
// (grouped_matmul.stream_cuts).
bool stream_cuts(int items, int slices, int ctas) {
  const long long rest =
      static_cast<long long>(items % ctas) * slices;
  for (int c = 1; c < ctas; ++c)
    if (static_cast<long long>(c) * rest / ctas % slices != 0) return true;
  return false;
}

// xl, wl: 3-d tensor maps of kMapWords each (grouped_matmul.tma_layout):
// x's dims (d, C, E) with box (64, N, 1), w's (f, d, E) with box (64, 64, 1).
template <int N, int NT>
int launch_stream(const void* x, const void* w, void* o, void* part, int E,
                  int C, int d, int f, int stages, int ctas,
                  const long long* xl, const long long* wl, long long soe,
                  long long soc, int vec_out, cudaStream_t stream) {
  using ST = StreamTile<N, NT>;
  const int col_tiles = (f + ST::kBF - 1) / ST::kBF;
  const int slices = (d + 63) / 64;
  const long long items = static_cast<long long>(E) * col_tiles;
  const int smem = ST::smem(stages);
  if (C > N || stages < 2 || smem > kSmemLimit || ctas < 1
      || items >= (1LL << 31) || ctas > items * slices
      || stream_cuts(static_cast<int>(items), slices, ctas)
             != (part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, wm;
  int err = encode_bf16_map(&xm, x, 3, xl);
  if (err == 0) err = encode_bf16_map(&wm, w, 3, wl);
  if (err != 0) return err;
  auto kernel = gmm_stream_kernel<N, NT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<ctas, kStreamThreads, smem, stream>>>(
      xm, wm, static_cast<bf16*>(o), static_cast<float*>(part), C, f,
      col_tiles, slices, static_cast<int>(items), stages, soe, soc,
      vec_out);
  e = cudaGetLastError();
  if (e != cudaSuccess || part == nullptr) return static_cast<int>(e);
  // Launched behind the stream kernel's CTAs (programmatic dependent
  // launch), so that it starts as soon as the last of them ends.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas - 1);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gmm_stream_fold_kernel,
                         static_cast<const float*>(part),
                         static_cast<bf16*>(o), C, N, ST::kBF, f, col_tiles,
                         slices, static_cast<int>(items), soe, soc, vec_out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int dispatch_stream(int rows, const void* x, const void* w, void* o,
                    void* part, int E, int C, int d, int f, int stages,
                    int ctas, const long long* xl, const long long* wl,
                    long long soe, long long soc, int vec_out,
                    cudaStream_t s) {
  switch (rows) {
    case 8:
      return launch_stream<8, NT>(x, w, o, part, E, C, d, f, stages, ctas,
                                  xl, wl, soe, soc, vec_out, s);
    case 16:
      return launch_stream<16, NT>(x, w, o, part, E, C, d, f, stages, ctas,
                                   xl, wl, soe, soc, vec_out, s);
    case 32:
      return launch_stream<32, NT>(x, w, o, part, E, C, d, f, stages, ctas,
                                   xl, wl, soe, soc, vec_out, s);
    case 64:
      return launch_stream<64, NT>(x, w, o, part, E, C, d, f, stages, ctas,
                                   xl, wl, soe, soc, vec_out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Variants, by the wrapper's plan (grouped_matmul.py::TC_VARIANTS and
// SYNC_VARIANT): 0 and 1 are the small-C stream (rows up to 32 and 64;
// grouped_matmul_bf16_stream); 2: 160 rows x 128 x 64 on wgmma, TMA, 3
// warpgroups, 6 stages; 3: 320 rows x 128 x 64 on wgmma, TMA, 3
// warpgroups, 4 stages; 4: rows TMA cannot read, 64 x 128 x 64 on
// mma.sync, 8 warps of 32 x 32, 4 stages.
int dispatch(const void* x, const void* w, void* o, int E, int C, int d,
             int f, int variant, int cluster, const long long* maps,
             const long long* st, cudaStream_t s) {
  if (variant == 4) {
    using TL = Tile<64, 128, 64, 2, 4, 4>;
    auto kernel = gmm_tc_kernel<64, 128, 64, 2, 4, 4>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(TL::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((C + 63) / 64, (f + 127) / 128, E);
    kernel<<<grid, TL::kThreads, TL::kSmem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<bf16*>(o), C, d, f, st[0], st[1], st[2], st[3], st[4],
        st[5]);
    return static_cast<int>(cudaGetLastError());
  }
  if (maps == nullptr || cluster != kCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* xl = maps;
  const long long* wl = maps + kMapWords;
  const int vec_out = st[4] % 8 == 0 && st[5] % 8 == 0
                      && reinterpret_cast<uintptr_t>(o) % 16 == 0;
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
// axis of each is contiguous.  variant picks the kernel and tile (see
// dispatch): 2 and 3 need `maps`, x's and w's tensor maps (kMapWords each),
// and `cluster` kCluster; 4 reads through the strides.
extern "C" int grouped_matmul_bf16_fwd(const void* x, const void* w, void* o,
                                       int E, int C, int d, int f,
                                       const long long* strides, int variant,
                                       const long long* maps, int cluster,
                                       void* stream) {
  return dispatch(x, w, o, E, C, d, f, variant, cluster, maps, strides,
                  static_cast<cudaStream_t>(stream));
}

// The small-C stream: `rows` (8, 16, 32 or 64, at least C) token rows a
// product, `bn` (256) output columns an item, a ring of `stages`
// slots, `ctas` persistent CTAs; `maps` as for grouped_matmul_bf16_fwd, x's
// box `rows` rows deep; o's element strides (expert, row).  `part` is f32
// scratch of ctas * 2 * bn * rows floats when some CTA's range starts inside
// an item (grouped_matmul.stream_pieces), else null.
extern "C" int grouped_matmul_bf16_stream(const void* x, const void* w,
                                          void* o, void* part, int E, int C,
                                          int d, int f, int rows, int bn,
                                          int stages, int ctas,
                                          const long long* maps,
                                          const long long* o_strides,
                                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long soe = o_strides[0], soc = o_strides[1];
  const int vec_out = soe % 8 == 0 && soc % 8 == 0
                      && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  const long long* xl = maps;
  const long long* wl = maps + kMapWords;
  if (bn == 256)
    return dispatch_stream<4>(rows, x, w, o, part, E, C, d, f, stages, ctas,
                              xl, wl, soe, soc, vec_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
