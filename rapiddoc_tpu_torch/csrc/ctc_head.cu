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
// compute bound. At the demo vocabulary (V = 96) it is bytes bound and
// tiny.
//
// Design. The TPU kernel walks the vocabulary tiles of one row tile in
// sequence and carries (max, argmax, exp-sum) in scratch memory. Blocks
// on the card run in no order, so the vocabulary is cut into
// `n_splits` contiguous ranges as well as the rows into 64-row tiles:
// a block owns one (row tile, vocabulary range) pair and loops over the
// 128-column tiles of its range, keeping each thread's online triple in
// registers. A second small kernel merges the `n_splits` triples of
// each row. N*V is wide and short (10240 x 18710), so splitting V is
// what fills the 132 SMs. The product is plain fp32 FMA over bf16
// inputs with fp32 accumulation, from shared-memory tiles (a register-
// blocked 4x8 micro-tile per thread); tensor cores (mma/wgmma) are left
// for a later change.
//
// Ties go to the lowest index, as on the TPU: each thread visits its
// columns in increasing order and replaces its max only on a strictly
// greater logit; merging two triples with equal max keeps the smaller
// index. Columns past V are skipped, which is what the TPU's padding
// bias of -1e30 amounts to.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // rows per block
constexpr int TV = 128;       // vocabulary columns per tile
constexpr int TK = 32;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each 4 rows x 8 columns
constexpr float NEG = -1e30f;

struct Triple {
  float m;  // running max logit
  int a;    // its column
  float s;  // sum of exp(l - m)
};

__device__ __forceinline__ void merge(Triple& t, float m, int a, float s) {
  if (m > t.m) {
    t.s = t.s * __expf(t.m - m) + s;
    t.m = m;
    t.a = a;
  } else {
    t.s += s * __expf(m - t.m);
    if (m == t.m && a < t.a) t.a = a;
  }
}

__global__ void __launch_bounds__(THREADS)
ctc_head_partial(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ b,
                 float* __restrict__ part_m, int* __restrict__ part_a,
                 float* __restrict__ part_s,
                 int n, int c, int v, int tiles_per_split) {
  __shared__ __align__(16) float xs[TK][TM];
  __shared__ __align__(16) float ws[TK][TV];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // column group
  const int ty = tid >> 4;   // row group
  const int row0 = blockIdx.x * TM;
  const int split = blockIdx.y;
  const int tile_begin = split * tiles_per_split;
  const int n_tiles = (v + TV - 1) / TV;
  const int tile_end = min(tile_begin + tiles_per_split, n_tiles);

  Triple st[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) st[i] = Triple{NEG, 0, 0.f};

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int col0 = tile * TV;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < c; k0 += TK) {
      // x chunk: (TM rows) x (TK depth), stored transposed as xs[k][m]
      for (int idx = tid; idx < TM * TK; idx += THREADS) {
        const int m = idx % TM, k = idx / TM;
        const int r = row0 + m, kk = k0 + k;
        xs[k][m] = (r < n && kk < c)
                       ? __bfloat162float(x[(size_t)r * c + kk]) : 0.f;
      }
      // W chunk: (TK depth) x (TV columns), W is (C, V) row major
      for (int idx = tid; idx < TK * TV; idx += THREADS) {
        const int col = idx % TV, k = idx / TV;
        const int cc = col0 + col, kk = k0 + k;
        ws[k][col] = (cc < v && kk < c)
                         ? __bfloat162float(w[(size_t)kk * v + cc]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < TK; ++k) {
        const float4 xa = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
        const float4 w0 = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
        const float4 w1 =
            *reinterpret_cast<const float4*>(&ws[k][64 + tx * 4]);
        const float xr[4] = {xa.x, xa.y, xa.z, xa.w};
        const float wc[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xr[i], wc[j], acc[i][j]);
      }
      __syncthreads();
    }

    // online (max, argmax, exp-sum) over this thread's 8 columns, in
    // increasing column order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (col >= v) continue;
      const float bias = b[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float l = acc[i][j] + bias;
        if (l > st[i].m) {
          st[i].s = st[i].s * __expf(st[i].m - l) + 1.f;
          st[i].m = l;
          st[i].a = col;
        } else {
          st[i].s += __expf(l - st[i].m);
        }
      }
    }
  }

  // merge the 16 column groups of each row: they are lanes 0-15 or
  // 16-31 of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, st[i].m, off);
      const int oa = __shfl_xor_sync(0xffffffffu, st[i].a, off);
      const float os = __shfl_xor_sync(0xffffffffu, st[i].s, off);
      merge(st[i], om, oa, os);
    }
    const int r = row0 + ty * 4 + i;
    if (tx == 0 && r < n) {
      const size_t o = (size_t)split * n + r;
      part_m[o] = st[i].m;
      part_a[o] = st[i].a;
      part_s[o] = st[i].s;
    }
  }
}

__global__ void ctc_head_merge(const float* __restrict__ part_m,
                               const int* __restrict__ part_a,
                               const float* __restrict__ part_s,
                               int* __restrict__ ids,
                               float* __restrict__ conf, int n,
                               int n_splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  Triple t{part_m[r], part_a[r], part_s[r]};
  for (int s = 1; s < n_splits; ++s) {
    const size_t o = (size_t)s * n + r;
    merge(t, part_m[o], part_a[o], part_s[o]);
  }
  ids[r] = t.a;
  conf[r] = 1.f / fmaxf(t.s, 1e-30f);
}

}  // namespace

// x (n, c) bf16, w (c, v) bf16, b (v,) fp32, all contiguous; scratch
// part_m / part_a / part_s hold n_splits * n entries each; ids (n,)
// int32 and conf (n,) fp32 receive the result. Launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
extern "C" int ctc_head_launch(const void* x, const void* w, const void* b,
                               void* part_m, void* part_a, void* part_s,
                               void* ids, void* conf, int n, int c, int v,
                               int n_splits, int tiles_per_split,
                               void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((n + TM - 1) / TM, n_splits);
  ctc_head_partial<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
      static_cast<float*>(part_m), static_cast<int*>(part_a),
      static_cast<float*>(part_s), n, c, v, tiles_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_head_merge<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const int*>(part_a),
      static_cast<const float*>(part_s), static_cast<int*>(ids),
      static_cast<float*>(conf), n, n_splits);
  return static_cast<int>(cudaGetLastError());
}
