// Fused CTC head for Hopper: logits = x.W + b, then per row the argmax id
// and its softmax probability 1 / sum(exp(l - max)), with the (N, V)
// logits never written to device memory.
//
// Replaces K1, the Pallas kernel rapiddoc_tpu/ops/ctc_head.py:30 `_kernel`
// (launched at :90 by `fused_ctc_argmax`, wrapped by `ctc_head_decode`).
//
// What bounds it on the H100: 2*N*C*V operations against (N*C + C*V) * 2
// input bytes. At the published vocabulary (V = 18710, C = 120,
// N = 10240) that is 4.6e10 operations on 7 MB, about 6,500 operations a
// byte, far above the card's ~295 bf16 operations a byte: the work is
// compute bound (46.5 us at the bf16 tensor rate). The epilogue is a
// co-limit: N*V = 1.9e8 exps at 16 a clock per SM are about 50 us on
// 132 SMs. At the demo vocabulary (V = 96) the work is tiny and bound by
// bytes.
//
// Design. The TPU kernel walks the vocabulary tiles of one row tile in
// sequence and carries (max, argmax, exp-sum) in scratch memory. Blocks
// on the card run in no order, so a block owns one 128-row tile and a
// contiguous range of 64-column vocabulary tiles. It stages its x tile
// once in shared memory by cp.async (C = 120 zero-padded to K = 128) and
// streams the W tiles of its range (all of K x 64 columns, 16 KB) through
// a ring of 4 stages: one thread issues each tile as one TMA copy (a 2-D
// tensor map of the weight, zero past C and V, 128-byte swizzle so that
// ldmatrix's 8 rows hit different banks), so the next tiles load while
// this one is multiplied and folded, and no warp spends issue slots on
// copies. TMA needs rows that start on 16 bytes (V = 18710 unpadded:
// 37420 bytes does not): the recognizer pads its head once (ops/ctc_head.py
// `pad_ctc_kernel`), and the wrapper gives any other weight that layout.
//
// The product runs on tensor cores: mma.sync m16n8k16, bf16 in, fp32
// accumulate, A fragments by ldmatrix from the x tile and B fragments by
// ldmatrix.trans from the k-major W tile. 8 warps as 4 (rows) x 2
// (columns), each 32 rows x 32 columns; lane (g, q) holds rows g, g+8 of
// each 16-row half and columns 8j + 2q, 8j + 2q + 1 (j = 0..3): 8
// columns of 4 rows, in increasing order.
//
// Epilogue, kept lean because its exps are a co-limit: bias add, each
// row's max over the lane's 8 columns, one rescale of the running sum
// only when that max is a new maximum, and one exp per logit. The exp is
// __expf (ex2.approx of x * log2 e): its relative error is about 2^-22
// near x = 0, where the terms that carry the sum lie, and under 2e-6 for
// |x| <= 16, whose terms weigh at most e^-16 each; conf = 1 / sum then
// stays within the 1e-5 x plain + 1e-8 the card check allows against the
// plain version's torch.exp. Quads merge by shuffles, the 2 column warps
// through shared memory. With one vocabulary range (V = 96) the block
// writes ids and conf itself; otherwise a second small kernel merges the
// ranges. Columns past V are skipped, which is what the TPU's padding
// bias of -1e30 amounts to.
#include "argmax_head.cuh"

namespace {

using namespace argmax_head;

constexpr int BM = 128;           // rows per block
constexpr int BN = 64;            // vocabulary columns per tile (128 bytes)
constexpr int STAGES = 4;         // W ring depth
constexpr int THREADS = 256;      // 8 warps: 4 row warps x 2 column warps
constexpr int MAX_C = 256;        // the widest x the shared memory holds

__host__ __device__ inline int k_padded(int c) { return (c + 15) / 16 * 16; }

// 1024 bytes of slack to align the ring to the swizzle's period, the ring
// of K x 128-byte W tiles, then the x tile (rows padded by 16 bytes so
// that ldmatrix's 8 rows fall in different banks)
__host__ __device__ inline size_t smem_bytes(int c) {
  const int kp = k_padded(c);
  return 1024 + (size_t)STAGES * kp * 128 + (size_t)BM * (kp + 8) * 2;
}

// W tiles come by TMA through `wmap`; x (rows 16-byte aligned, `ldx`
// elements apart) by cp.async.
__global__ void __launch_bounds__(THREADS, 2)
ctc_head_partial(const __grid_constant__ CUtensorMap wmap,
                 const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ b,
                 float* __restrict__ part_m, int* __restrict__ part_a,
                 float* __restrict__ part_s, int* __restrict__ ids,
                 float* __restrict__ conf, int n, int c, int v, int ldx,
                 int tiles_per_range) {
  extern __shared__ uint8_t smem_raw[];
  const int kp = k_padded(c);
  const int stage_bytes = kp * 128;
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = ring + STAGES * stage_bytes;
  const int sx = (kp + 8) * 2;  // bytes per x tile row
  __shared__ Triple red[2][BM];
  __shared__ __align__(8) uint64_t full[STAGES];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int n_tiles = (v + BN - 1) / BN;
  const int tile_begin = blockIdx.y * tiles_per_range;
  const int tile_end = min(tile_begin + tiles_per_range, n_tiles);
  const int total = max(tile_end - tile_begin, 0);

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    fence_async_shared();
  }
  __syncthreads();

  // the block's x tile, zero past C and past N, in the first group
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  const int x_pieces = kp / 8;
  for (int p = tid; p < BM * x_pieces; p += THREADS) {
    const int r = p / x_pieces, pc = (p % x_pieces) * 16;
    const int row = row0 + r;
    copy16(xs + r * sx + pc, xb + (size_t)min(row, n - 1) * ldx * 2, pc, c * 2, row < n);
  }
  cp_async_commit();

  // W tile s of the range (all K rows, BN columns) into ring slot
  // s % STAGES; rows past C read zero
  auto issue = [&](int s) {
    if (tid == 0 && s < total) {
      mbar_expect_tx(&full[s % STAGES], stage_bytes);
      tma_load_2d(ring + (s % STAGES) * stage_bytes, &wmap, (tile_begin + s) * BN, 0,
                  &full[s % STAGES]);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  cp_async_wait<0>();  // x; the weight's stages wait on their barriers

  Triple t[4];  // rows wm*32 + 16*(i/2) + g + 8*(i%2)
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i] = empty_triple();

  for (int s = 0; s < total; ++s) {
    mbar_wait(&full[s % STAGES], (s / STAGES) & 1);
    // every thread is done with slot (s - 1) % STAGES: refill it
    __syncthreads();
    if (tid == 0) fence_async_shared();
    issue(s + STAGES - 1);
    const int col0 = (tile_begin + s) * BN + wn * 32 + 2 * q;  // + 8j + e
    float bias[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * j + e;
        bias[2 * j + e] = col < v ? __ldg(b + col) : 0.f;
      }
    const uint8_t* st = ring + (s % STAGES) * stage_bytes;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
    for (int ks = 0; ks < kp / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], xs + (wm * 32 + mi * 16 + (lane & 15)) * sx +
                               (ks * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, st + swizzle128(ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                              (wn * 32 + nb * 16 + (lane >> 4) * 8) * 2));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nb], a[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * nb + 1], a[mi], bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int mi = i >> 1, h = i & 1;
      float l[8];
      int col[8];
      bool valid[8];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int z = 2 * j + e;
          l[z] = acc[mi][j][2 * h + e] + bias[z];
          col[z] = col0 + 8 * j + e;
          valid[z] = col[z] < v;
        }
      fold_run<true, 8>(t[i], l, col, valid);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    shfl_merge<true>(t[i], 3);
    if (q == 0) red[wn][wm * 32 + 16 * (i >> 1) + g + 8 * (i & 1)] = t[i];
  }
  __syncthreads();
  if (tid < BM) {
    Triple r = red[0][tid];
    merge<true>(r, red[1][tid].m, red[1][tid].a, red[1][tid].s);
    const int row = row0 + tid;
    if (row < n) {
      if (gridDim.y == 1) {
        ids[row] = r.a;
        conf[row] = 1.f / fmaxf(r.s, 1e-30f);
      } else {
        const size_t o = (size_t)blockIdx.y * n + row;
        part_m[o] = r.m;
        part_a[o] = r.a;
        part_s[o] = r.s;
      }
    }
  }
}

__global__ void ctc_head_merge(const float* __restrict__ part_m,
                               const int* __restrict__ part_a,
                               const float* __restrict__ part_s,
                               int* __restrict__ ids,
                               float* __restrict__ conf, int n,
                               int n_ranges) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  Triple t{part_m[r], part_a[r], part_s[r]};
  for (int s = 1; s < n_ranges; ++s) {
    const size_t o = (size_t)s * n + r;
    merge<true>(t, part_m[o], part_a[o], part_s[o]);
  }
  ids[r] = t.a;
  conf[r] = 1.f / fmaxf(t.s, 1e-30f);
}

std::atomic<unsigned long long> smem_allowed{0};

}  // namespace

// x (n, c) bf16, rows `ldx` elements apart; w (c, v) bf16 with row stride
// ldw >= v elements; x, w and both strides in bytes multiples of 16 (the
// wrapper sees to it); c <= 256; b (v,) fp32 contiguous. With
// n_ranges == 1 the kernel writes ids (n,) int32 and conf (n,) fp32
// itself and the part_* pointers are unused; otherwise part_m / part_a /
// part_s hold n_ranges * n entries each and a merge kernel follows.
// Launches on `stream`, allocates nothing, and returns the first CUDA
// error (cudaGetLastError() after each launch).
extern "C" int ctc_head_launch(const void* x, const void* w, const void* b,
                               void* part_m, void* part_a, void* part_s,
                               void* ids, void* conf, int n, int c, int v,
                               int ldx, int ldw, int n_ranges, int tiles_per_range,
                               void* stream) {
  if (n <= 0) return 0;
  if (c <= 0 || c > MAX_C || v <= 0 || ldx < c || ldw < v || n_ranges <= 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 || (2LL * ldx) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || (2LL * ldw) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // (columns, rows) of bf16; a box is one tile: all K rows of 64 columns
  CUtensorMap map;
  cudaError_t err = tensor_map_2d(&map, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, c, 2LL * ldw, BN,
                                  k_padded(c));
  // the shared memory of the widest x, so that one setting serves every c
  if (err == cudaSuccess)
    err = allow_dynamic_smem(reinterpret_cast<const void*>(ctc_head_partial),
                             static_cast<int>(smem_bytes(MAX_C)), smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n + BM - 1) / BM, n_ranges);
  ctc_head_partial<<<grid, THREADS, smem_bytes(c), st>>>(
      map, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(b),
      static_cast<float*>(part_m), static_cast<int*>(part_a),
      static_cast<float*>(part_s), static_cast<int*>(ids),
      static_cast<float*>(conf), n, c, v, ldx, tiles_per_range);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_ranges == 1) return static_cast<int>(err);
  ctc_head_merge<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const int*>(part_a),
      static_cast<const float*>(part_s), static_cast<int*>(ids),
      static_cast<float*>(conf), n, n_ranges);
  return static_cast<int>(cudaGetLastError());
}
