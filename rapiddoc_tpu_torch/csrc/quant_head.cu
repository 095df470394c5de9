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
// bias against 2*N*K*V = 0.82 GFLOP, about 31 operations a byte, far below
// the card's ~295 bf16 operations a byte. The kernel is bound by bytes:
// 26.0 MB / 3.35 TB/s = 7.8 us.
//
// Design. All the parallelism is in V. A grid of at most one block per
// SM (132) splits the 128-column vocabulary tiles between its blocks:
// block b of B takes tiles b, b + B, b + 2B, ... (3 at V = 50000), so that
// at any time the blocks read neighbouring 128-byte pieces of the same
// weight rows, which keeps the HBM's pages open. A block streams its tiles
// in 128-row (k) stages of 16 KB through a ring of 6 stages in shared
// memory: one thread issues each stage as one TMA copy (a 2-D tensor map
// of the weight, zero past V and K, 128-byte swizzle so that the lanes'
// reads below hit every bank once), so 80 KB are in flight per SM (the
// HBM rate needs about 25 KB) and a whole tile's K = 512 is requested at
// once: at V = 57 (one tile, one block) every load of the weight is
// issued together. TMA needs rows that start on 16 bytes:
// FormulaRecognizer pads its head once (ops/layout.py `aligned_rows`),
// and the wrapper gives any other weight (V = 57 unpadded) that layout.
//
// The product runs on tensor cores: mma.sync m16n8k16, bf16 in, fp32
// accumulate; 16 rows are exactly the mma's M. x (16 rows x K) is staged
// once per block by cp.async, and each warp takes its A fragments for
// the whole of K = 512 (the decoders' d_model; less zero-pads) into
// registers by ldmatrix, indexed at compile time; fewer rows (N = 4) are zeroed registers, never padding in memory. int8
// converts to bf16 exactly (|q| <= 127 needs 8 significant bits): a lane
// reads one 32-bit word (4 neighbouring columns) from each of the rows
// k 2q, 2q+1, 2q+8, 2q+9 of a 16-deep step, and byte permutes build, for
// each of the 4 columns, the B fragment of one mma whose column g is that
// column. So warp c of the 4 column warps covers columns 32c .. 32c+31
// with 4 mmas a step, and the accumulators of lane (g, q) hold 8
// neighbouring columns 32c+8q .. 32c+8q+7 of rows g and g+8. The two
// halves of each stage's 128 rows go to two sets of 4 warps, each loading
// all 16 words of its 4 steps before it converts and multiplies; at the
// end of a tile the two sets trade the row each does not keep through
// shared memory and add (half 0 + half 1, so both sides of the trade
// round alike).
//
// Epilogue: `* scale + bias` unfused (__fmul_rn, __fadd_rn), as the plain
// version rounds it; scale and bias are fetched at the start of each
// tile, so their latency hides behind the tile's loads. Each lane folds
// its 8 columns into an online (max, argmax, exp-sum) triple, with a
// rescale only when its 8 columns raise the max. The exp is __expf
// (ex2.approx of x * log2 e): its relative error is about 2^-22 near
// x = 0, where the terms that carry the sum lie, and under 2e-6 for
// |x| <= 16, whose terms weigh at most e^-16 each, so conf = 1 / sum stays
// within the 1e-5 x plain + 1e-8 that the card check allows against the
// plain version's torch.exp. Quads merge by shuffles, the 4 column warps
// through shared memory. With one block per row block the block writes
// ids and conf itself; otherwise each block writes its triples and the
// last block of the row block to finish (an atomic ticket) merges them in
// a fixed order: one launch either way. Columns past V are skipped, which
// is what the TPU's padding (scale 0, bias -1e30) amounts to.
#include "argmax_head.cuh"

namespace {

using namespace argmax_head;

constexpr int TV = 128;            // vocabulary columns per tile (128 bytes)
constexpr int KC = 128;            // k rows per stage
constexpr int STAGES = 6;          // ring depth: 5 stages of 16 KB in flight
constexpr int STAGE_BYTES = KC * TV;  // 128-byte rows, 128-byte swizzle
constexpr int THREADS = 256;       // 4 column warps x 2 k halves
constexpr int ROWS = 16;           // rows per block: the mma's M
constexpr int NKC = 4;             // stages per tile: K <= 512
constexpr int MAX_K = NKC * KC;
constexpr int XCHG_BYTES = (THREADS / 32) * 32 * 8 * 4;
constexpr int MAX_BLOCKS = 132;    // blocks a row block may be split into
constexpr int MERGE_PER_THREAD = (MAX_BLOCKS + THREADS / ROWS - 1) / (THREADS / ROWS);

// x rows staged for ldmatrix: K padded to MAX_K, plus 16 bytes so that
// the 8 rows of a matrix fall in different banks
constexpr int XROW = (MAX_K + 8) * 2;

// dynamic shared memory: 1024 bytes of slack to align the ring to the
// swizzle's period, the ring, the trade buffer and the staged x
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + XCHG_BYTES + ROWS * XROW;

// The 4 bytes of `lo` (row k) and of `hi` (row k + 1), 4 neighbouring
// columns, as 4 bf16 pairs (row k in the low half): each byte b becomes
// the float 2^23 + (b + 128) by a byte permute, minus 2^23 + 128 exactly
// b, whose upper 16 bits are its bf16.
__device__ __forceinline__ void int8_pairs_to_bf16x2(uint32_t lo, uint32_t hi,
                                                     uint32_t (&out)[4]) {
  lo ^= 0x80808080u;
  hi ^= 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t sel = 0x7540u | j;  // byte j, then 0x00, 0x00, 0x4B
    const float fl = __uint_as_float(__byte_perm(lo, 0x4B000000u, sel)) - 8388736.f;
    const float fh = __uint_as_float(__byte_perm(hi, 0x4B000000u, sel)) - 8388736.f;
    out[j] = __byte_perm(__float_as_uint(fl), __float_as_uint(fh), 0x7632);
  }
}

// The weight tiles come by TMA through `wmap`; x (rows 16-byte aligned,
// `ldx` elements apart) by cp.async.
__global__ void __launch_bounds__(THREADS, 1)
quant_head_partial(const __grid_constant__ CUtensorMap wmap,
                   const unsigned short* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   float* __restrict__ part_m, int* __restrict__ part_a,
                   float* __restrict__ part_s, int* __restrict__ ids,
                   float* __restrict__ conf, unsigned int* __restrict__ tickets,
                   int n, int k, int v, int ldx, int tiles_per_block) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* xchg = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  uint8_t* xs = ring + STAGES * STAGE_BYTES + XCHG_BYTES;
  __shared__ Triple red[4][ROWS];
  __shared__ bool last_block;
  __shared__ __align__(8) uint64_t full[STAGES];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cw = warp & 3;   // column warp: tile columns 32 cw .. 32 cw + 31
  const int kh = warp >> 2;  // which 64 of each stage's 128 k rows
  const int g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.y * ROWS;
  const int n_tiles = (v + TV - 1) / TV;
  // block b takes tiles b, b + B, b + 2B, ... (B blocks in x): at any
  // time the blocks read neighbouring 128-byte pieces of the same rows
  const int my_tiles =
      max(min(tiles_per_block, (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1), 0);
  const int total = my_tiles * NKC;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(&full[i], 1);
    fence_async_shared();
  }
  __syncthreads();

  // x rows of this block (zero past K; rows past N are not read), by
  // cp.async while the weight's first stages load
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  for (int p = tid; p < ROWS * (MAX_K / 8); p += THREADS) {
    const int r = p / (MAX_K / 8), pc = (p % (MAX_K / 8)) * 16;
    if (row0 + r < n) copy16(xs + r * XROW + pc, xb + (size_t)(row0 + r) * ldx * 2, pc, k * 2, true);
  }
  cp_async_commit();

  // stage s (the block's tile s / NKC, rows 128 (s % NKC) ..) into ring
  // slot s % STAGES
  auto issue = [&](int s) {
    if (tid == 0 && s < total) {
      const int tile = blockIdx.x + (s / NKC) * gridDim.x, kc = s % NKC;
      mbar_expect_tx(&full[s % STAGES], STAGE_BYTES);
      tma_load_2d(ring + (s % STAGES) * STAGE_BYTES, &wmap, tile * TV, kc * KC, &full[s % STAGES]);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // this warp's A fragments for every stage, by ldmatrix from the staged
  // x; rows past N (N = 4 pads to 16) are zero registers
  cp_async_wait<0>();
  __syncthreads();
  const bool live0 = row0 + g < n, live1 = row0 + g + 8 < n;
  uint32_t af[NKC][4][4];
#pragma unroll
  for (int kc = 0; kc < NKC; ++kc)
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      ldmatrix_x4(af[kc][step],
                  xs + (lane & 15) * XROW + (kc * KC + kh * 64 + step * 16 + (lane >> 4) * 8) * 2);
      if (!live0) af[kc][step][0] = af[kc][step][2] = 0u;
      if (!live1) af[kc][step][1] = af[kc][step][3] = 0u;
    }

  const int my_row = row0 + g + 8 * kh;  // the row this lane folds
  const int woff[2] = {swizzle128(2 * q, cw * 32 + 4 * g), swizzle128(2 * q + 1, cw * 32 + 4 * g)};
  Triple t = empty_triple();

  for (int tl = 0; tl < my_tiles; ++tl) {
    const int col0 = (blockIdx.x + tl * gridDim.x) * TV + cw * 32 + 8 * q;  // this lane's 8 columns
    float acc[4][4];
    float sc[8], bi[8];
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc) {
      const int s = tl * NKC + kc;
      mbar_wait(&full[s % STAGES], (s / STAGES) & 1);
      // every thread is done with slot (s - 1) % STAGES: refill it
      __syncthreads();
      if (tid == 0) fence_async_shared();
      issue(s + STAGES - 1);
      if (kc == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool in = col0 + i < v;
          sc[i] = in ? __ldg(scale + col0 + i) : 0.f;
          bi[i] = in ? __ldg(bias + col0 + i) : 0.f;
        }
      }
      // all 16 words of the stage first, then convert and multiply; the
      // rows' swizzle depends only on 2q + (row & 1), so two offsets serve
      const uint8_t* st = ring + (s % STAGES) * STAGE_BYTES;
      uint32_t wd[4][4];
#pragma unroll
      for (int step = 0; step < 4; ++step)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          wd[step][r] = *reinterpret_cast<const uint32_t*>(
              st + (kh * 64 + step * 16 + 8 * (r >> 1)) * 128 + woff[r & 1]);
#pragma unroll
      for (int step = 0; step < 4; ++step) {
        uint32_t b0[4], b1[4];
        int8_pairs_to_bf16x2(wd[step][0], wd[step][1], b0);
        int8_pairs_to_bf16x2(wd[step][2], wd[step][3], b1);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[j], af[kc][step], b0[j], b1[j]);
      }
    }
    // lane (g, q) of mma j holds column 32 cw + 8q + j (c[0], c[2]) and
    // 32 cw + 8q + 4 + j (c[1], c[3]); rows g (c[0..1]) and g+8 (c[2..3])
    float keep[8], give[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // selects, not indices: acc stays in registers
      keep[j] = kh ? acc[j][2] : acc[j][0];
      keep[4 + j] = kh ? acc[j][3] : acc[j][1];
      give[j] = kh ? acc[j][0] : acc[j][2];
      give[4 + j] = kh ? acc[j][1] : acc[j][3];
    }
    float* mine = xchg + (warp * 32 + lane) * 8;
    const float* theirs = xchg + ((warp ^ 4) * 32 + lane) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) mine[i] = give[i];
    __syncthreads();
    float l[8];
    int col[8];
    bool valid[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dot = keep[i] + theirs[i];
      l[i] = __fadd_rn(__fmul_rn(dot, sc[i]), bi[i]);
      col[i] = col0 + i;
      valid[i] = col0 + i < v && my_row < n;
    }
    fold_run<true, 8>(t, l, col, valid);
  }

  shfl_merge<true>(t, 3);
  if (q == 0) red[cw][g + 8 * kh] = t;
  __syncthreads();
  if (tid < ROWS) {
    Triple r = red[0][tid];
#pragma unroll
    for (int c = 1; c < 4; ++c) merge<true>(r, red[c][tid].m, red[c][tid].a, red[c][tid].s);
    const int row = row0 + tid;
    if (row < n) {
      if (gridDim.x == 1) {
        ids[row] = r.a;
        conf[row] = 1.f / fmaxf(r.s, 1e-30f);
      } else {
        const size_t o = (size_t)blockIdx.x * n + row;
        part_m[o] = r.m;
        part_a[o] = r.a;
        part_s[o] = r.s;
      }
    }
  }
  if (gridDim.x == 1) return;

  // The last block of this row block to finish merges every block's
  // triple and resets its ticket for the next launch.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(tickets + blockIdx.y, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // thread i takes row i % 16 of blocks i / 16, i / 16 + 16, ..., all its
  // loads in flight together; then lanes i and i + 16 of a warp, and the 8
  // warps through shared memory, merge in a fixed order
  const int mr = tid % ROWS, m0 = tid / ROWS;
  const int row = row0 + mr;
  Triple m = empty_triple();
  if (row < n) {
    float pm[MERGE_PER_THREAD], ps[MERGE_PER_THREAD];
    int pa[MERGE_PER_THREAD];
#pragma unroll
    for (int j = 0; j < MERGE_PER_THREAD; ++j) {
      const int s = m0 + j * (THREADS / ROWS);
      const size_t o = (size_t)min(s, (int)gridDim.x - 1) * n + row;
      pm[j] = __ldcg(part_m + o);
      pa[j] = __ldcg(part_a + o);
      ps[j] = __ldcg(part_s + o);
    }
#pragma unroll
    for (int j = 0; j < MERGE_PER_THREAD; ++j)
      if (m0 + j * (THREADS / ROWS) < (int)gridDim.x) merge<true>(m, pm[j], pa[j], ps[j]);
  }
  shfl_merge<true>(m, 16);
  Triple* per_warp = reinterpret_cast<Triple*>(ring);  // [warp][row]
  if (lane < ROWS) per_warp[warp * ROWS + lane] = m;
  __syncthreads();
  if (tid < ROWS && row0 + tid < n) {
    Triple r = per_warp[tid];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w)
      merge<true>(r, per_warp[w * ROWS + tid].m, per_warp[w * ROWS + tid].a, per_warp[w * ROWS + tid].s);
    ids[row0 + tid] = r.a;
    conf[row0 + tid] = 1.f / fmaxf(r.s, 1e-30f);
  }
  if (tid == 0) tickets[blockIdx.y] = 0u;
}

std::atomic<unsigned long long> smem_allowed{0};

}  // namespace

// The largest depth K the kernel takes.
extern "C" int quant_head_max_k() { return MAX_K; }

// x (n, k) bf16, rows `ldx` elements apart; wq (k, v) int8 with row stride
// ldw >= v bytes; x, wq and both strides in bytes multiples of 16 (the
// wrapper sees to it); scale (v,) and bias (v,) fp32 contiguous;
// k <= quant_head_max_k(). n_blocks blocks (at most 132) share the tiles
// of each 16-row block, tiles_per_block each at most. With n_blocks == 1
// the kernel writes ids (n,) int32 and conf (n,) fp32 and the other
// pointers are unused. Otherwise part_m / part_a / part_s hold
// n_blocks * n entries each, and `tickets` holds one zero uint32 per
// 16-row block: the last block of each row block to finish merges the
// blocks' triples and sets its ticket back to zero. One launch either
// way, on `stream`; allocates nothing; returns the first CUDA error
// (cudaGetLastError() after the launch).
extern "C" int quant_head_launch(const void* x, const void* wq,
                                 const void* scale, const void* bias,
                                 void* part_m, void* part_a, void* part_s,
                                 void* ids, void* conf, void* tickets, int n, int k,
                                 int v, int ldx, int ldw, int n_blocks, int tiles_per_block,
                                 void* stream) {
  if (n <= 0) return 0;
  if (k <= 0 || k > MAX_K || v <= 0 || ldx < k || ldw < v || n_blocks <= 0 ||
      n_blocks > MAX_BLOCKS || reinterpret_cast<uintptr_t>(x) % 16 || (2LL * ldx) % 16 ||
      reinterpret_cast<uintptr_t>(wq) % 16 || ldw % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // the weight as a tensor map of (columns, rows) int8; a box is one
  // stage, 128 rows of 128 bytes; past V and past K the tile reads zero
  CUtensorMap map;
  cudaError_t e = tensor_map_2d(&map, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, v, k, ldw, TV, KC);
  if (e == cudaSuccess) e = allow_dynamic_smem(reinterpret_cast<const void*>(quant_head_partial),
                                               SMEM_BYTES, smem_allowed);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_blocks, (n + ROWS - 1) / ROWS);
  quant_head_partial<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const unsigned short*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(part_m), static_cast<int*>(part_a),
      static_cast<float*>(part_s), static_cast<int*>(ids), static_cast<float*>(conf),
      static_cast<unsigned int*>(tickets), n, k, v, ldx, tiles_per_block);
  return static_cast<int>(cudaGetLastError());
}
