// Shared parts of the two fused argmax heads (ctc_head.cu, quant_head.cu):
// the online (max, argmax, exp-sum) triple and its merge with lowest-index
// ties, quad and warp shuffles, bf16 mma.sync m16n8k16 with its fragment
// layout, ldmatrix, TMA tiles with mbarriers and the 128-byte swizzle
// (tensor maps kept per tensor), shared memory set once per kernel, and
// cp.async copies of 16-byte aligned rows.
//
// Both heads compute, per row, argmax_j l_j and 1 / sum_j exp(l_j - max)
// over logits l = x . W (+ epilogue) that never leave the SM. A thread
// owns a few columns of a few rows (the mma accumulator layout below),
// visits its columns in increasing order and replaces its max only on a
// strictly greater logit; every merge of two triples with equal maxima
// keeps the smaller index. So the first maximum wins, as in the TPU
// kernels and in torch.argmax.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace argmax_head {

constexpr float NEG = -1e30f;       // the max of a triple that saw no column
constexpr int NO_INDEX = 0x7fffffff;

struct Triple {
  float m;  // running max logit
  int a;    // its column
  float s;  // sum of exp(l - m)
};

__device__ __forceinline__ Triple empty_triple() { return Triple{NEG, NO_INDEX, 0.f}; }

// exp as each head needs it: FAST takes __expf (ex2.approx of x * log2 e),
// otherwise the full-precision expf.
template <bool FAST>
__device__ __forceinline__ float head_exp(float x) {
  return FAST ? __expf(x) : expf(x);
}

// Fold the triple (m, a, s) into t. Ties keep the smaller index.
template <bool FAST>
__device__ __forceinline__ void merge(Triple& t, float m, int a, float s) {
  if (m > t.m) {
    t.s = t.s * head_exp<FAST>(t.m - m) + s;
    t.m = m;
    t.a = a;
  } else {
    t.s += s * head_exp<FAST>(m - t.m);
    if (m == t.m && a < t.a) t.a = a;
  }
}

// Merge across the lanes whose index differs only in the bits of `mask`
// (1 | 2: the 4 lanes of an mma quad; 31: the whole warp).
template <bool FAST>
__device__ __forceinline__ void shfl_merge(Triple& t, int mask) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (!(mask & off)) continue;
    const float om = __shfl_xor_sync(0xffffffffu, t.m, off);
    const int oa = __shfl_xor_sync(0xffffffffu, t.a, off);
    const float os = __shfl_xor_sync(0xffffffffu, t.s, off);
    merge<FAST>(t, om, oa, os);
  }
}

// Fold a run of logits l[0..n) at columns col[0..n) (increasing) into t:
// the run's max first, a rescale of the sum only when the run raises the
// max, then one exp per logit. valid[i] false skips a column.
template <bool FAST, int RUN>
__device__ __forceinline__ void fold_run(Triple& t, const float (&l)[RUN],
                                         const int (&col)[RUN],
                                         const bool (&valid)[RUN]) {
  float rm = NEG;
  int ra = NO_INDEX;
#pragma unroll
  for (int i = 0; i < RUN; ++i)
    if (valid[i] && l[i] > rm) {
      rm = l[i];
      ra = col[i];
    }
  if (rm > t.m) {
    t.s *= head_exp<FAST>(t.m - rm);
    t.m = rm;
    t.a = ra;
  }
#pragma unroll
  for (int i = 0; i < RUN; ++i)
    if (valid[i]) t.s += head_exp<FAST>(l[i] - t.m);
}

// ---------------------------------------------------------------- mma.sync
//
// mma.sync.m16n8k16 row.col, bf16 inputs, fp32 accumulators. In a warp,
// lane = 4 * g + q (g = lane / 4 the group, q = lane % 4 its place in
// the quad):
//   A (16 x 16, rows x k): a[0] = (row g, k 2q, 2q+1), a[1] = (row g+8,
//     same k), a[2] = (row g, k 2q+8, 2q+9), a[3] = (row g+8, k 2q+8..9);
//   B (16 x 8, k x cols):  b[0] = (k 2q, 2q+1; col g), b[1] = (k 2q+8,
//     2q+9; col g); the lower k in the lower 16 bits;
//   C (16 x 8):            c[0], c[1] = (row g; cols 2q, 2q+1),
//                          c[2], c[3] = (row g+8; cols 2q, 2q+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8. Without .trans, r[i] is matrix i in the A layout above.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// With .trans, each thread receives (row 2q, col g), (row 2q+1, col g)
// of each matrix: from a k-major tile (rows = k, columns contiguous) that
// is the B layout above.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// ------------------------------------------------- TMA and mbarriers

// One 2-D tile from a tensor map into shared memory; completion counts
// down the bytes of `bar` (the tile's full size, zero-filled past the
// tensor's edges).
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// This thread's arrival, announcing `bytes` that copies will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Order this thread's earlier shared-memory accesses before later ones of
// the async proxy (TMA) and make barrier initialisation visible to it.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime so
// that the kernels' libraries link against nothing but the CUDA runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

struct MapKey {
  const void* base;
  int type, cols, rows;
  long long row_bytes;
  int box_cols, box_rows;
  bool operator==(const MapKey& o) const {
    return base == o.base && type == o.type && cols == o.cols && rows == o.rows &&
           row_bytes == o.row_bytes && box_cols == o.box_cols && box_rows == o.box_rows;
  }
};

constexpr int MAP_CACHE = 16;  // tensor maps kept per library

// A 2-D tensor map of `rows` rows of `cols` elements, `row_bytes` apart
// (base and row_bytes multiples of 16), read in boxes of box_rows x
// box_cols (box_cols elements make 128 bytes) with the 128-byte swizzle;
// outside the tensor a box reads zero. A map encodes only these values,
// so the last MAP_CACHE maps are kept and reused for the same values: the
// models' head weights stay put, so each is encoded once.
inline cudaError_t tensor_map_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                                 int cols, int rows, long long row_bytes, int box_cols,
                                 int box_rows) {
  static std::mutex lock;
  static EncodeTiled encode = nullptr;
  static MapKey keys[MAP_CACHE];
  static CUtensorMap maps[MAP_CACHE];
  static int used = 0, next = 0;
  const MapKey key{base, static_cast<int>(type), cols, rows, row_bytes, box_cols, box_rows};
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return cudaSuccess;
    }
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  keys[next] = key;
  maps[next] = *map;
  used = used < MAP_CACHE ? used + 1 : MAP_CACHE;
  next = (next + 1) % MAP_CACHE;
  return cudaSuccess;
}

// Let `kernel` take `bytes` of dynamic shared memory, once per device:
// `done` holds a bit for each device (of the first 64) already set.
inline cudaError_t allow_dynamic_smem(const void* kernel, int bytes,
                                      std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// Byte offset of (row, byte col) in a tile of 128-byte rows stored with
// TMA's 128-byte swizzle: the 16-byte chunk index is XORed with row % 8,
// which spreads 8 rows' same column over all banks.
__device__ __forceinline__ int swizzle128(int row, int col) {
  return row * 128 + ((((col >> 4) ^ (row & 7))) << 4) + (col & 15);
}

// Copy the 16 bytes at byte `off` of a row (`src_row`, 16-byte aligned,
// `valid` bytes of it real) to the 16-byte slot `dst` by cp.async; bytes
// past `valid`, and the whole slot when `live` is false, read as zero.
__device__ __forceinline__ void copy16(uint8_t* dst, const uint8_t* src_row, int off,
                                       int valid, bool live) {
  const int left = live ? valid - off : 0;
  cp_async16(dst, left > 0 ? src_row + off : src_row, left <= 0 ? 0 : (left < 16 ? left : 16));
}

}  // namespace argmax_head
