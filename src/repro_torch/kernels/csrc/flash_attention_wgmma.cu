// Flash attention forward (prefill) on Hopper's tensor cores (sm_90a), bf16:
// GQA, causal and/or sliding window, FlashAttention-3's shape.
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
// ms at 989 TFLOP/s.  The kernel it replaced (FlashAttention-2 on
// mma.sync, four warps issuing their own cp.async copies) reached 0.21 of
// that bound: mma.sync cannot reach the wgmma rate, softmax never overlapped
// the tensor cores, and every warp stalled on each tile's copy.
//
// Design: a persistent grid, one CTA of three warpgroups per SM, each CTA
// walking work items (b*h, 128-row query block), heaviest causal blocks
// first, so that one item's last products and stores overlap the next
// item's first copies.
// - Warpgroup 0 is the producer: it gives up registers (setmaxnreg) and
//   one thread issues TMA copies: Q once per work item, then K and V in
//   128-key tiles through a ring of 2 slots (3 or 4 were slower on the
//   H100, tools/torch_kernel_ablate.py), each slot with a full and an
//   empty mbarrier
//   (K and V apart, so that Q K^T starts before V lands).  Rows at or past
//   S or T arrive as zeros.
// - Warpgroups 1 and 2 are consumers with 240 registers, 64 query rows
//   each.  Per tile: S = Q K^T as an SS wgmma (m64n128k16, Q and K K-major
//   in the 128-byte swizzle); P = exp2(S - m) rounded to bf16 in registers,
//   where the f32 accumulator layout of S is the A-fragment layout of the
//   next product; O += P V as an RS wgmma with V MN-major (the transpose
//   bit).  l sums the rounded P on the tensor cores too (l += P 1, an
//   m64n8k16 wgmma against a tile of ones: no unpacking and no serial
//   adds), so the weights P V applies are normalised exactly.
// - Overlap: the next tile's Q K^T and this tile's P V are issued
//   together, and the next tile's max and exponentials run while P V is
//   still in flight; O is rescaled once P V is done.  At D > 64 two named
//   barriers make the consumer warpgroups take turns to issue, so that
//   one's softmax runs beside the other's products.
// - Key tiles that causality or the window masks whole for the block are
//   skipped (key_tiles in flash_attention.py is the Python twin); tiles
//   that no row of a warpgroup masks skip the mask arithmetic
//   (mask_free).  Keys at or past T are masked by index: a zero-filled key
//   would score 0, not -1e30.
// - Head dims 16, 32, 64 take 64 columns, 112 and 128 take 128: rows load
//   as 64-column boxes of 128 bytes, and columns past D (the tensor map's
//   dimension 0) arrive as zeros, which add nothing to Q K^T; the output
//   keeps its first D columns.
//
// Inputs are read through strides with TMA tensor maps (the model passes
// (B,S,H,D) tensors as (B,H,S,D) views without a copy); their dimensions,
// byte strides and boxes come from the wrapper (flash_attention.tma_layout).
// Every stride and base must be 16-byte aligned.  The output is written
// through o's strides, two bf16 at a time.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// the launch goes on the caller's stream, nothing is allocated, and the
// return value is the CUDA error of the encoding or the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "tma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kBQ = 128;                // query rows per CTA
constexpr int kBKV = 128;               // keys per tile
constexpr int kStages = 2;              // K and V ring slots
constexpr int kWGRows = 64;             // query rows per consumer warpgroup
constexpr int kThreads = 384;           // producer + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kMapWords = 11;           // a 4-d map: 4 dims, 3 strides, 4 box

// Shared memory, from a 1024-byte aligned base: Q, the K ring, the V ring
// (each a row of DP / 64 panels of 64 columns, 128 bytes a row), a 1024-byte
// tile of bf16 ones (the B operand of l += P 1), then the barriers: q_full,
// q_empty, k_full[kStages], v_full, k_empty, v_empty.
template <int DP>
struct Layout {
  static constexpr int kPanels = DP / 64;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTileBytes = kBKV * DP * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kOnes = kV + kStages * kTileBytes;
  static constexpr int kBar = kOnes + 1024;
  static constexpr int kBars = 2 + 4 * kStages;
  static constexpr int kBytes = kBar + kBars * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   bf16* __restrict__ o, int BH, int H, int G, int S,
                   int T_len, long long sob, long long soh, long long sos,
                   int causal, int window, float scale) {
  constexpr int DP = D <= 64 ? 64 : 128;
  using L = Layout<DP>;
  constexpr int KS = (D + 15) / 16;     // k16 steps of Q K^T
  constexpr int NS = kBKV / 8;          // n8 blocks of S
  constexpr int ND = DP / 8;            // n8 blocks of O
  constexpr int KV = kBKV / 16;         // k16 steps of P V
  // Warpgroups take turns to issue at D > 64 only: at D <= 64 the
  // exponentials take as long as the products, and the turns left the
  // tensor cores idle (tools/torch_kernel_ablate.py, no_pingpong).
  constexpr bool kPingPong = DP > 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  // Work item i: query block n_qb - 1 - i / BH of head i % BH, so that
  // the heaviest causal blocks come first and a block's heads (which share
  // their kv heads) run side by side; CTA c takes items c, c + gridDim.x,
  // ... (flash_attention.work_items).  Its keys: tiles from k_lo
  // (flash_attention.key_tiles).
  const int n_qb = (S + kBQ - 1) / kBQ;
  const int n_items = n_qb * BH;
  auto item = [&](int i, int& q0, int& b, int& h, int& k_lo) {
    q0 = (n_qb - 1 - i / BH) * kBQ;
    const int bh = i % BH;
    b = bh / H;
    h = bh - b * H;
    k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    k_lo = (k_lo / kBKV) * kBKV;
    const int k_hi = causal ? min(T_len, min(q0 + kBQ, S)) : T_len;
    return k_hi > k_lo ? (k_hi - k_lo + kBKV - 1) / kBKV : 0;
  };

  if (threadIdx.x < 256) {              // the ones tile
    reinterpret_cast<uint32_t*>(smem + L::kOnes)[threadIdx.x] = 0x3F803F80u;
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);              // one arrive per consumer warpgroup
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 2);
      mbar_init(v_empty + s, 2);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: Q of an item once its predecessor's products no longer
    // read Q, then its K and V tiles; slots and phases run on across items.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int tg = 0, it = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        int q0, b, h, k_lo;
        const int n = item(i, q0, b, h, k_lo);
        if (n == 0) continue;
        const int kvh = h / G;
        mbar_wait(q_empty, (it & 1) ^ 1);
        mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_4d(smem + p * kBQ * 128, &qmap, q_full, 64 * p, q0, h, b);
        for (int t = 0; t < n; ++t) {
          const int s = (tg + t) % kStages;
          const uint32_t ph = ((tg + t) / kStages) & 1;
          const int k0 = k_lo + t * kBKV;
          unsigned char* kt = smem + L::kK + s * L::kTileBytes;
          unsigned char* vt = smem + L::kV + s * L::kTileBytes;
          mbar_wait(k_empty + s, ph ^ 1);
          mbar_expect_tx(k_full + s, L::kTileBytes);
#pragma unroll
          for (int p = 0; p < L::kPanels; ++p)
            tma_load_4d(kt + p * kBKV * 128, &kmap, k_full + s, 64 * p, k0,
                        kvh, b);
          mbar_wait(v_empty + s, ph ^ 1);
          mbar_expect_tx(v_full + s, L::kTileBytes);
#pragma unroll
          for (int p = 0; p < L::kPanels; ++p)
            tma_load_4d(vt + p * kBKV * 128, &vmap, v_full + s, 64 * p, k0,
                        kvh, b);
        }
        tg += n;
        ++it;
      }
    }
    return;
  }

  // Consumers: warpgroup g owns rows r0 .. r0 + 63 of each item; thread
  // (warp, lane) holds rows ra and ra + 8 of S and O, and in each n8 block
  // j columns 8 j + 2 (lane % 4) and + 1.
  setmaxnreg_inc<kConsumerRegs>();
  const int g = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int my_bar = 1 + g;             // named barriers 1 and 2
  const int other_bar = 2 - g;
  const float scale2 = scale * kLog2e;  // scores in base 2
  const uint64_t ones = smem_desc(smem + L::kOnes, 16, 1024);
  int r0 = 0, ra = 0;

  float acc[ND * 4];
  float s[NS * 4];
  uint32_t p[KV][4];
  float m[2];
  float l[4];                           // row ra in l[0], l[1]; ra + 8
#pragma unroll
  for (int i = 0; i < KV; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[i][r] = 0u;

  // S = Q K^T for the tile in slot `stage` (issued, not waited for).
  auto issue_qk = [&](int stage) {
    const unsigned char* kt = smem + L::kK + stage * L::kTileBytes;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t da = smem_desc(
          smem + (ks / 4) * kBQ * 128 + g * kWGRows * 128 + (ks % 4) * 32,
          16, 1024);
      const uint64_t db =
          smem_desc(kt + (ks / 4) * kBKV * 128 + (ks % 4) * 32, 16, 1024);
      wgmma_m64n128k16_ss(s, da, db, ks > 0);
    }
  };
  // O += P V for the tile in slot `stage` (V's 8-key groups 1024 bytes
  // apart, its 64-column panels kBKV * 128), and l += P 1.
  auto issue_pv = [&](int stage) {
    const unsigned char* vt = smem + L::kV + stage * L::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < KV; ++kk) {
      const uint64_t db = smem_desc(vt + kk * 16 * 128, kBKV * 128, 1024);
      if constexpr (DP == 128)
        wgmma_m64n128k16_rs_tb(acc, p[kk], db, 1);
      else
        wgmma_m64n64k16_rs_tb(acc, p[kk], db, 1);
      wgmma_m64n8k16_rs(l, p[kk], ones, 1);
    }
  };
  // The rows' new max m (in base-2 units, scores times scale2) and the
  // correction corr of what came before; S becomes exp2(S * scale2 - m).
  // A tile that masks a key of one of the warpgroup's rows is scaled and
  // masked first; the others fold the scale into the exponent's FMA.
  auto softmax = [&](int k0, float* corr) {
    const bool unmasked = k0 + kBKV <= T_len
                          && (!causal || k0 + kBKV - 1 <= r0)
                          && (window <= 0 || r0 + kWGRows - 1 - k0 < window);
    if (!unmasked) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kpos = k0 + j * 8 + (lane % 4) * 2 + (r & 1);
          const int qpos = ra + (r >> 1) * 8;
          bool ok = kpos < T_len;
          if (causal) ok = ok && qpos >= kpos;
          if (window > 0) ok = ok && (qpos - kpos) < window;
          s[j * 4 + r] = ok ? s[j * 4 + r] * scale2 : kNegInf;
        }
      }
    }
    // Row maxima over four independent chains (two a row).
    float c[4] = {s[0], s[1], s[2], s[3]};
#pragma unroll
    for (int j = 1; j < NS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[r] = fmaxf(c[r], s[j * 4 + r]);
    float mx[2] = {fmaxf(c[0], c[1]), fmaxf(c[2], c[3])};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (unmasked) mx[r] *= scale2;    // scale2 > 0 keeps the order
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(mx[r], m[r]);
      corr[r] = exp2_ftz(m[r] - mx[r]);
      m[r] = mx[r];
    }
    if (unmasked) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          s[j * 4 + r] = exp2_ftz(fmaf(s[j * 4 + r], scale2, -m[r >> 1]));
    } else {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          s[j * 4 + r] = exp2_ftz(s[j * 4 + r] - m[r >> 1]);
    }
  };
  // Once P V is done: rescale O and l (unless no row of the warp changed
  // its max), and round P to bf16 for the next P V (n8 blocks 2 kk and
  // 2 kk + 1 of S are k16 step kk's A fragment).
  auto rescale_and_pack = [&](const float* corr) {
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j * 4 + r] *= corr[r >> 1];
#pragma unroll
      for (int r = 0; r < 4; ++r) l[r] *= corr[r >> 1];
    }
#pragma unroll
    for (int kk = 0; kk < KV; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16x2(s[kk * 8 + r * 2], s[kk * 8 + r * 2 + 1]);
  };
  // Before issuing: the registers wgmma reads are final.  After a wait:
  // what it wrote is read only from here on.
  auto fence_s = [&]() {
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) fence_operand(s[i]);
  };
  auto fence_acc_p = [&]() {
#pragma unroll
    for (int i = 0; i < ND * 4; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_operand(l[i]);
#pragma unroll
    for (int kk = 0; kk < KV; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        asm volatile("" : "+r"(p[kk][r])::"memory");
  };

  int tg = 0, it = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    int q0, b, h, k_lo;
    const int n = item(i, q0, b, h, k_lo);
    r0 = q0 + g * kWGRows;
    ra = r0 + warp * 16 + lane / 4;
    m[0] = m[1] = kNegInf;
#pragma unroll
    for (int r = 0; r < 4; ++r) l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < ND * 4; ++j) acc[j] = 0.f;
    if (n > 0) {
      if (kPingPong && g == 1) bar_arrive(1, 256);   // 1 issues first
      mbar_wait(q_full, it & 1);
      float corr[2];

      // The first tile: S only.
      mbar_wait(k_full + tg % kStages, (tg / kStages) & 1);
      if (kPingPong) bar_sync(my_bar, 256);
      fence_s();
      fence_acc_p();
      wgmma_fence();
      issue_qk(tg % kStages);
      wgmma_commit();
      if (kPingPong) bar_arrive(other_bar, 256);
      wgmma_wait<0>();
      fence_s();
      if (tid == 0) {
        mbar_arrive(k_empty + tg % kStages);
        if (n == 1) mbar_arrive(q_empty);
      }
      softmax(k_lo, corr);
      rescale_and_pack(corr);

      for (int t = 1; t < n; ++t) {
        const int sk = (tg + t) % kStages;
        const int sv = (tg + t - 1) % kStages;
        mbar_wait(k_full + sk, ((tg + t) / kStages) & 1);
        if (kPingPong) bar_sync(my_bar, 256);
        fence_s();
        fence_acc_p();
        wgmma_fence();
        issue_qk(sk);
        wgmma_commit();
        mbar_wait(v_full + sv, ((tg + t - 1) / kStages) & 1);
        issue_pv(sv);
        wgmma_commit();
        if (kPingPong) bar_arrive(other_bar, 256);
        wgmma_wait<1>();                // S of tile t is done
        fence_s();
        if (tid == 0) {
          mbar_arrive(k_empty + sk);
          if (t == n - 1) mbar_arrive(q_empty);   // Q is read no more
        }
        softmax(k_lo + t * kBKV, corr);
        wgmma_wait<0>();                // P V of tile t - 1 is done
        fence_acc_p();
        if (tid == 0) mbar_arrive(v_empty + sv);
        rescale_and_pack(corr);
      }

      // The last tile's P V.
      const int sv = (tg + n - 1) % kStages;
      mbar_wait(v_full + sv, ((tg + n - 1) / kStages) & 1);
      if (kPingPong) bar_sync(my_bar, 256);
      fence_acc_p();
      wgmma_fence();
      issue_pv(sv);
      wgmma_commit();
      if (kPingPong && g == 0) bar_arrive(other_bar, 256);   // 1's last turn
      wgmma_wait<0>();
      fence_acc_p();
      if (tid == 0) mbar_arrive(v_empty + sv);
      tg += n;
      ++it;
    }

    // l holds each row's whole sum (every column of P 1 is the same); the
    // producer is already loading the next item.
    bf16* op = o + b * sob + h * soh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = ra + r * 8;
      if (qpos >= S) continue;
      const float denom = fmaxf(l[2 * r], 1e-30f);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int col = j * 8 + (lane % 4) * 2;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(op + qpos * sos + col) =
              __floats2bfloat162_rn(acc[j * 4 + 2 * r] / denom,
                                    acc[j * 4 + 2 * r + 1] / denom);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int S, int T_len, int ctas, const long long* maps,
           const long long* ost, int causal, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = encode_bf16_map(&qm, q, 4, maps);
  if (err == 0) err = encode_bf16_map(&km, k, 4, maps + kMapWords);
  if (err == 0) err = encode_bf16_map(&vm, v, 4, maps + 2 * kMapWords);
  if (err != 0) return err;
  constexpr int smem = Layout<(D <= 64 ? 64 : 128)>::kBytes;
  static_assert(smem <= 232448, "shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_wgmma_kernel<D><<<ctas, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), B * H, H, H / K, S, T_len, ost[0],
      ost[1], ost[2], causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ctas: the persistent grid (flash_attention.plan: one CTA per SM at most,
// no more than the work items).  maps: three 4-d tensor maps, q's, k's and
// v's, of kMapWords each: dims (D, rows, heads, batch), the byte strides of
// rows, heads and batch, and the box (64, 128, 1, 1).  ostrides: o's
// element strides (batch, head, seq); its rows must be 4-byte aligned.
// scale: D^-0.5 rounded to f32 by the caller, as the reference rounds it.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int H, int K, int S, int T, int D,
                                         int ctas, const long long* maps,
                                         const long long* ostrides,
                                         int causal, int window, float scale,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, H, K, S, T, ctas, maps, ostrides,
                        causal, window, scale, s);
    case 32:
      return launch<32>(q, k, v, o, B, H, K, S, T, ctas, maps, ostrides,
                        causal, window, scale, s);
    case 64:
      return launch<64>(q, k, v, o, B, H, K, S, T, ctas, maps, ostrides,
                        causal, window, scale, s);
    case 112:
      return launch<112>(q, k, v, o, B, H, K, S, T, ctas, maps, ostrides,
                         causal, window, scale, s);
    case 128:
      return launch<128>(q, k, v, o, B, H, K, S, T, ctas, maps, ostrides,
                         causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
