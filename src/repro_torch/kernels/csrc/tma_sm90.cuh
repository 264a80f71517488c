// Hopper's asynchronous copy and synchronisation primitives (sm_90a), shared
// by the warp-specialised kernels (flash_attention_wgmma.cu and the prefill
// and small-C regimes of grouped_matmul_tc.cu): the Tensor Memory
// Accelerator (TMA) with its tensor maps, mbarriers with transaction counts,
// programmatic dependent launch, thread-block clusters, named barriers,
// register reallocation (setmaxnreg) and stmatrix.
//
// A tensor map is encoded on the host with cuTensorMapEncodeTiled, fetched
// from the driver through cudaGetDriverEntryPoint (no -lcuda), from the
// dimensions, byte strides and box that the Python wrapper computes (so that
// the CPU tests check them), and passed to the kernel as a
// __grid_constant__ parameter.  Every box is loaded in the 128-byte swizzle:
// 16-byte chunk c of 128-byte row r lands at chunk c ^ (r % 8) of its
// 1024-byte atom, the layout wgmma's descriptors (smem_desc) read.

#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

// ---- mbarriers ------------------------------------------------------------

static __device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA) and
// to the other CTAs of the cluster.
static __device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of TMA traffic in this phase.
static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive on the barrier at the same offset in the shared memory of CTA
// `rank` of this cluster.  Only a release of a slot the caller has read
// with wgmma (done, by wgmma.wait_group) goes through here, so the
// arrive's default ordering suffices: with .release.cluster the grouped
// matmul's prefill took about twice as long on the H100
// (tools/torch_kernel_ablate.py, release_cluster).
static __device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                           uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so waiting on parity 1 passes at once (a producer's first
// wait on an empty slot).
static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA loads ------------------------------------------------------------

static __device__ __forceinline__ void tma_load_3d(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c0,
                                                   int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

static __device__ __forceinline__ void tma_load_4d(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c0,
                                                   int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box into the same offset of the shared memory of every CTA of the
// cluster in `mask`; each CTA's barrier at bar's offset gets the bytes that
// landed there.
static __device__ __forceinline__ void tma_load_3d_multicast(
    void* dst, const CUtensorMap* map, uint64_t* bar, uint16_t mask, int c0,
    int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "h"(mask),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- programmatic dependent launch ---------------------------------------

// A grid launched after this one with the attribute
// cudaLaunchAttributeProgrammaticStreamSerialization may start once every
// CTA of this one has called launch_dependents (or exited); it waits in
// grid_dependency_wait until this grid has finished and its writes are
// visible.  Only the launch overlaps: no read comes early.
static __device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

static __device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---- clusters, named barriers, registers ----------------------------------

static __device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster (all lanes of a warp together).
static __device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads:
// bar_sync waits for the count, bar_arrive adds to it without waiting.
static __device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

static __device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
static __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
static __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices of a warp's mma fragments into shared memory,
// transposed: register i of lane l holds row l / 4, columns 2 (l % 4) and
// + 1 of matrix i, and lane 8 i + j gives the address of the 16-byte row j
// of matrix i's transpose (its column j).
static __device__ __forceinline__ void stmatrix_x4_trans(void* p, uint32_t r0,
                                                         uint32_t r1,
                                                         uint32_t r2,
                                                         uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(smem_addr(p)),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// 2^x on the MUFU unit, without the subnormal handling of exp2f: a result
// below 2^-126 is 0 (a softmax weight that small of its row's largest).
static __device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

static __device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- tensor maps (host) ---------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions from `layout`: rank sizes
// (innermost first), rank - 1 byte strides of dimensions 1 .. rank - 1,
// rank box sizes, as the wrappers' tma_layout computes them.  Elements
// outside the tensor read as 0.  Returns 0 or a CUDA error.
static inline int encode_bf16_map(CUtensorMap* map, const void* base,
                                  int rank, const long long* layout) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5], elem[5];
  for (int i = 0; i < rank; ++i) {
    dims[i] = static_cast<cuuint64_t>(layout[i]);
    box[i] = static_cast<cuuint32_t>(layout[2 * rank - 1 + i]);
    elem[i] = 1;
  }
  for (int i = 0; i < rank - 1; ++i)
    strides[i] = static_cast<cuuint64_t>(layout[rank + i]);
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}
