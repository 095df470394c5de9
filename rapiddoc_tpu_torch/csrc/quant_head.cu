// Int8-weight fused head for Hopper: logits = (bf16(x) . bf16(wq)) * scale
// + bias with fp32 accumulation, the per-column scale applied after the
// dot; then per row the argmax id and its softmax probability
// 1 / sum(exp(l - max)), with the (N, V) logits never written to device
// memory.
//
// Replaces K2, the Pallas kernel rapiddoc_tpu/ops/quant_head.py:50
// `_kernel` (launched at :113 by `fused_argmax_int8`).
//
// What bounds it on the H100. The formula decode calls it once a step
// with N <= 16 rows (the decode batch), K = 512 and, at the published
// vocabulary, V = 50000: 25.6 MB of int8 weight plus 0.4 MB of scale and
// bias against 2*N*K*V = 0.82 GFLOP. That is about 31 operations a byte,
// far below the card's ~295 bf16 operations a byte: the kernel is bound
// by bytes, 26.0 MB / 3.35 TB/s = 7.8 us, against 0.83 us for the
// operations at the bf16 tensor rate.
//
// Design. With 16 rows there is nothing to split in N, so all the
// parallelism is in V. Each block stages x (rows x K) once in shared
// memory as fp32 and owns a contiguous range of 128-column tiles. Each
// of its 8 warps takes one eighth of K for the same tile; a lane owns 4
// neighbouring columns and reads them with one 4-byte load a row of K,
// so a warp reads 128 contiguous bytes. The int8 values convert exactly
// to fp32 (as they do to bf16) and the product is plain fp32 FMA. The 8
// warps' partial sums meet in shared memory, two rows at a time; then
// each thread applies `* scale + bias` (unfused, as the plain version
// rounds it) and carries an online (max, argmax, exp-sum) triple per row
// over the tiles of its range. A second small kernel merges the ranges'
// triples, one warp per row. This simple version is latency bound on
// the H100: each warp keeps only a few 4-byte loads a lane in flight,
// and at 127 registers a thread (N = 16) two blocks fit an SM, far from
// the bytes in flight the HBM rate needs (PERF.md has its times). A
// weight tile staged in shared memory by cp.async/TMA, tensor cores
// (mma.sync m16n8k16 fits 16 rows exactly) and a persistent grid are
// left for a later change.
//
// Ties go to the lowest index, as on the TPU: a thread visits its
// columns in increasing order and replaces its max only on a strictly
// greater logit; merging two triples with equal max keeps the smaller
// index. Columns past V are skipped, which is what the TPU's padding
// (scale 0, bias -1e30) amounts to.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TV = 128;        // vocabulary columns per tile: 32 lanes x 4
constexpr int THREADS = 256;   // 8 warps, each one eighth of K
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;

struct Triple {
  float m;  // running max logit
  int a;    // its column
  float s;  // sum of exp(l - m)
};

__device__ __forceinline__ void merge(Triple& t, float m, int a, float s) {
  if (m > t.m) {
    t.s = t.s * expf(t.m - m) + s;
    t.m = m;
    t.a = a;
  } else {
    t.s += s * expf(m - t.m);
    if (m == t.m && a < t.a) t.a = a;
  }
}

__device__ __forceinline__ void shfl_merge(Triple& t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, t.m, off);
    const int oa = __shfl_xor_sync(0xffffffffu, t.a, off);
    const float os = __shfl_xor_sync(0xffffffffu, t.s, off);
    merge(t, om, oa, os);
  }
}

template <int ROWS>
__global__ void __launch_bounds__(THREADS, 2)
quant_head_partial(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ wq,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   float* __restrict__ part_m, int* __restrict__ part_a,
                   float* __restrict__ part_s, int n, int k, int v,
                   int tiles_per_range, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // xs[kk * ROWS + r]
  float* red = smem + (size_t)k * ROWS;    // red[(warp * 2 + h) * TV + col]
  __shared__ float wm[WARPS][ROWS / 2];
  __shared__ int wa[WARPS][ROWS / 2];
  __shared__ float ws[WARPS][ROWS / 2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * ROWS;
  for (int idx = tid; idx < ROWS * k; idx += THREADS) {
    const int r = idx / k, kk = idx - r * k;
    const int row = row0 + r;
    xs[kk * ROWS + r] =
        row < n ? __bfloat162float(x[(size_t)row * k + kk]) : 0.f;
  }
  __syncthreads();

  const int kslice = (k + WARPS - 1) / WARPS;
  const int k_begin = min(k, warp * kslice);
  const int k_end = min(k, k_begin + kslice);
  const int half = tid / TV;  // the row of a pair this thread sums
  const int ct = tid % TV;    // the tile column this thread sums
  const int n_tiles = (v + TV - 1) / TV;
  const int tile_begin = blockIdx.x * tiles_per_range;
  const int tile_end = min(tile_begin + tiles_per_range, n_tiles);

  Triple st[ROWS / 2];
#pragma unroll
  for (int i = 0; i < ROWS / 2; ++i) st[i] = Triple{NEG, 0, 0.f};

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int c0 = tile * TV + lane * 4;
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

    if (vec && c0 + 4 <= v) {
      const int8_t* wp = wq + (size_t)k_begin * v + c0;
#pragma unroll 4
      for (int kk = k_begin; kk < k_end; ++kk, wp += v) {
        const int packed = __ldg(reinterpret_cast<const int*>(wp));
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = static_cast<float>(static_cast<int8_t>(packed >> (8 * j)));
        const float4* xr = reinterpret_cast<const float4*>(xs + kk * ROWS);
#pragma unroll
        for (int r4 = 0; r4 < ROWS / 4; ++r4) {
          const float4 xv = xr[r4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[4 * r4 + 0][j] = fmaf(xv.x, w[j], acc[4 * r4 + 0][j]);
            acc[4 * r4 + 1][j] = fmaf(xv.y, w[j], acc[4 * r4 + 1][j]);
            acc[4 * r4 + 2][j] = fmaf(xv.z, w[j], acc[4 * r4 + 2][j]);
            acc[4 * r4 + 3][j] = fmaf(xv.w, w[j], acc[4 * r4 + 3][j]);
          }
        }
      }
    } else {
      // the tail of a vocabulary that is not a multiple of 4 (or a weight
      // not 4-byte aligned): byte loads, zero past V
      for (int kk = k_begin; kk < k_end; ++kk) {
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = c0 + j < v ? static_cast<float>(wq[(size_t)kk * v + c0 + j])
                            : 0.f;
        const float4* xr = reinterpret_cast<const float4*>(xs + kk * ROWS);
#pragma unroll
        for (int r4 = 0; r4 < ROWS / 4; ++r4) {
          const float4 xv = xr[r4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[4 * r4 + 0][j] = fmaf(xv.x, w[j], acc[4 * r4 + 0][j]);
            acc[4 * r4 + 1][j] = fmaf(xv.y, w[j], acc[4 * r4 + 1][j]);
            acc[4 * r4 + 2][j] = fmaf(xv.z, w[j], acc[4 * r4 + 2][j]);
            acc[4 * r4 + 3][j] = fmaf(xv.w, w[j], acc[4 * r4 + 3][j]);
          }
        }
      }
    }

    const int col = tile * TV + ct;
    const float sc = col < v ? scale[col] : 0.f;
    const float bi = col < v ? bias[col] : 0.f;
    // the 8 warps' partial sums of rows (rr, rr + 1), then each thread's
    // online triple for row rr + half over its column
#pragma unroll
    for (int rr = 0; rr < ROWS; rr += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(red + (warp * 2 + h) * TV + lane * 4) =
            make_float4(acc[rr + h][0], acc[rr + h][1], acc[rr + h][2],
                        acc[rr + h][3]);
      __syncthreads();
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[(w * 2 + half) * TV + ct];
      __syncthreads();
      if (col < v) {
        const float l = __fadd_rn(__fmul_rn(s, sc), bi);
        Triple& t = st[rr / 2];
        if (l > t.m) {
          t.s = t.s * expf(t.m - l) + 1.f;
          t.m = l;
          t.a = col;
        } else {
          t.s += expf(l - t.m);
        }
      }
    }
  }

  // row 2i + half lives in warps half*4 .. half*4+3: merge inside each
  // warp, then across those four
#pragma unroll
  for (int i = 0; i < ROWS / 2; ++i) {
    shfl_merge(st[i]);
    if (lane == 0) {
      wm[warp][i] = st[i].m;
      wa[warp][i] = st[i].a;
      ws[warp][i] = st[i].s;
    }
  }
  __syncthreads();
  if (tid < ROWS) {
    const int h = tid & 1, i = tid >> 1;
    Triple t{NEG, 0, 0.f};
    for (int w = h * (WARPS / 2); w < (h + 1) * (WARPS / 2); ++w)
      merge(t, wm[w][i], wa[w][i], ws[w][i]);
    const int row = row0 + tid;
    if (row < n) {
      const size_t o = (size_t)blockIdx.x * n + row;
      part_m[o] = t.m;
      part_a[o] = t.a;
      part_s[o] = t.s;
    }
  }
}

__global__ void quant_head_merge(const float* __restrict__ part_m,
                                 const int* __restrict__ part_a,
                                 const float* __restrict__ part_s,
                                 int* __restrict__ ids,
                                 float* __restrict__ conf, int n,
                                 int n_ranges) {
  const int row = blockIdx.x;
  Triple t{NEG, 0, 0.f};
  for (int s = threadIdx.x; s < n_ranges; s += 32) {
    const size_t o = (size_t)s * n + row;
    merge(t, part_m[o], part_a[o], part_s[o]);
  }
  shfl_merge(t);
  if (threadIdx.x == 0) {
    ids[row] = t.a;
    conf[row] = 1.f / fmaxf(t.s, 1e-30f);
  }
}

template <int ROWS>
cudaError_t launch_partial(dim3 grid, size_t smem, cudaStream_t st,
                           const void* x, const void* wq, const void* scale,
                           const void* bias, void* part_m, void* part_a,
                           void* part_s, int n, int k, int v,
                           int tiles_per_range, bool vec) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        quant_head_partial<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  quant_head_partial<ROWS><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(part_m), static_cast<int*>(part_a),
      static_cast<float*>(part_s), n, k, v, tiles_per_range, vec);
  return cudaGetLastError();
}

}  // namespace

// x (n, k) bf16, wq (k, v) int8, scale (v,) and bias (v,) fp32, all
// contiguous; scratch part_m / part_a / part_s hold n_ranges * n entries
// each; ids (n,) int32 and conf (n,) fp32 receive the result. `rows` (4
// or 16) is the rows per block. Launches on `stream`, allocates nothing,
// and returns the first CUDA error (cudaGetLastError() after each launch).
extern "C" int quant_head_launch(const void* x, const void* wq,
                                 const void* scale, const void* bias,
                                 void* part_m, void* part_a, void* part_s,
                                 void* ids, void* conf, int n, int k, int v,
                                 int rows, int n_ranges, int tiles_per_range,
                                 void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec =
      (v % 4) == 0 && (reinterpret_cast<uintptr_t>(wq) & 3) == 0;
  const size_t smem = sizeof(float) * ((size_t)k * rows + WARPS * 2 * TV);
  const dim3 grid(n_ranges, (n + rows - 1) / rows);
  cudaError_t err;
  if (rows == 4) {
    err = launch_partial<4>(grid, smem, st, x, wq, scale, bias, part_m,
                            part_a, part_s, n, k, v, tiles_per_range, vec);
  } else if (rows == 16) {
    err = launch_partial<16>(grid, smem, st, x, wq, scale, bias, part_m,
                             part_a, part_s, n, k, v, tiles_per_range, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_head_merge<<<n, 32, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const int*>(part_a),
      static_cast<const float*>(part_s), static_cast<int*>(ids),
      static_cast<float*>(conf), n, n_ranges);
  return static_cast<int>(cudaGetLastError());
}
