// The gather and scatter probes P1a-P1g and P2: small kernels that measure
// the hash grid's two memory patterns on the card, random table gathers (its
// forward, HG1) and the scatter-add of its table gradient (HG2).
//
// Replaces the eight pallas_calls of the JAX package's probe scripts, each
// computing the same function:
//   P1a scripts/microbench_pallas.py:156 (pallas_scalar_gather, :143):
//       out[j] = table[idx[j]] over a (2^19, 2) f32 table, one 8-byte load
//       per index; unroll 1 a thread per index, unroll 8 eight gathers in
//       flight a lane, a warp's loads and stores coalesced (below)
//   P1b :201 (bench_pallas_vector_gather, :191): the same gather, a block per
//       8,192-index chunk
//   P1c :237 (bench_pallas_takealong_col, :225): whole 128-wide rows of a
//       (2^19, 128) f32 table, a warp per row, 16-byte loads
//   P1d :273 (bench_pallas_lane_gather, :261): out[r, c] = lut[idx[r, c]] of
//       a 128-entry lookup table (row 0 of the (8, 128) table) kept in shared
//       memory
//   P1e :311 (bench_pallas_sublane_gather, :297): out[r, c] = table[idx[r, c],
//       c] of a (512, 128) table
//   P1f :359 (pallas_scatter_add, :340): scatter-add of (M, 2) f32 updates
//       into a zeroed (2^19, 2) table, one 8-byte vector atomic per update
//   P1g :419 (pallas_onehot_grad, :396): the same gradient as the TPU's
//       one-hot products U^T (W * g): rows split as (a, b) = (row / 512, row %
//       512), each update rounded to bf16, sums in f32, output (T / 512, 512 *
//       F) with feature j in columns j*512 .. j*512+511
//   P2 scripts/microbench_pallas_gather.py:85 (make_pallas, :81, over
//       kernel_a/b/c, :45-78): 2^20 random row reads of an (8192, 128) f32
//       table in 4,096-index chunks, a block of 128 threads per chunk, each
//       thread one column: (a) one accumulator per chunk, written to its 8
//       output rows; (b) eight accumulators, row j summing the indices i = j
//       mod 8; (c) every row stored to an 8-row shared scratch at i mod 8,
//       whose last contents are the output.
//
// What bounds them on an H100: memory. The gathers move their compulsory
// bytes (indices, output, the table rows the indices touch) at best at the
// HBM rate; their random rows cost a 32-byte sector each (P1a, P1b: 8 B used
// of 32), unless the table stays in the 50 MB L2 (the 4 MB (2^19, 2) table
// does; the 256 MB (2^19, 128) table of P1c does not). The scatters issue
// one 8-byte vector atomic per update (P1f, P1g). The bounds are computed in
// tools/microbench_gather.py from each run's data.
//
// P1a: the gathers of a (2^19, 2) table that stays in L2 are bound by the
// L2's sector rate, not by the 50.3 MB the indices and output move through
// HBM (0.0163 ms): at M = 2^22, 4.19 M random 32-byte table sectors and 1.57
// M sectors of the streams. Unroll 1 moves them in 0.0395-0.0397 ms, ~145 G
// sectors/s, 2048 single gathers in flight an SM. A first unroll-8 design
// (a thread on 8 consecutive indices: 32-byte lane strides on the index
// loads, 64-byte lane strides on the float2 stores, so each store touched
// 32 sectors) took 0.0766-0.0777. Here a warp's index loads and stores are
// coalesced (scalar_gather8), with equal spans per warp so that no warp runs
// a last step alone: 0.0404-0.0408 ms, table[idx] 0.0497-0.0499. More
// gathers in flight buy nothing at that rate. Measured and dropped: 16-byte
// index loads with float4 stores (0.0466-0.0468), a grid-stride walk
// (0.0404-0.0417), no cache hints (0.0415-0.0421), the table through L2
// only (__ldcg, +0.0001-0.0008), 2-5 blocks an SM (0.0416-0.0460), 4
// gathers a lane (0.0398-0.0413), 32-bit index arithmetic at 8 blocks an SM
// (0.0410-0.0427).
//
// P1f: every update read once (16-byte loads of four indices and four
// updates) and added with one 8-byte atomicAdd(float2 *) (REDG.E.ADD.F32x2)
// into the zeroed output, P1g's scatter pass (vector_scatter) without the
// bf16 rounding. A first design of two scalar f32 atomics per update (8.39
// M, 4-byte index and 8-byte update loads, a grid capped at 8,192 blocks)
// took 0.1069-0.1074 ms; this one 0.0608-0.0612, index_add_ 0.0806-0.0811,
// bound by the L2's atomic unit as P1g is.
//
// P1e: the bytes bound is the indices read and the output written once
// (33.8 MB at M = 2^22, 0.0101 ms at 3.35 TB/s). Two things kept a first
// design (a 64-column slice of 128 KB per block, one block of 8 warps per
// SM, one index load in flight a thread) at 10x that: ~1 KB of loads in
// flight per SM, where the HBM rate needs ~15-20 KB, and every block of two
// waves refilling its slice from L2 (34 MB). Here a block keeps a 32-column
// slice (64 KB), so three blocks of 8 warps fit an SM; the grid is one
// persistent wave (SMs x resident blocks, a quarter per slice), each block
// loads its slice once with 16-byte loads and walks rows in groups of 8,
// lane l on column l of the slice: eight independent 128-byte index loads in
// flight a warp (24 KB a SM), and shared-memory reads of word r * 32 + l, on
// bank l whatever r, so without bank conflicts. The slices' refill is
// resident blocks x 64 KB (25.3 MB on 132 SMs), from L2, against 33.8 MB of
// compulsory traffic. Measured 0.0147-0.0149 ms (1.46x the bound; the first
// design 0.081), torch.gather 0.054 (NVIDIA H100 80GB HBM3, 700 W;
// tools/microbench_gather.py).
//
// P1g: the TPU forms the gradient as one-hot products because it has no
// scatter; on Hopper those products are 2 * 1024 * 1024 * 1024 operations per
// 1,024-index chunk, 8.8e12 over the 4,096 chunks of M = 2^22, at least 8.9
// ms at the 989 TFLOP/s dense bf16 peak: tensor cores are no way out. A first
// design (a block owning 8 rows a in shared memory, every block reading the
// whole index stream: 2.1 GB of index reads) took 5.94 ms. Here every update
// is read once (16-byte loads of four indices and four updates), rounded to
// bf16 in registers and added with one 8-byte atomicAdd(float2 *) into a
// zeroed row-major (rows, 2) f32 scratch (4 MB, resident in L2); a second
// kernel writes the scratch out as (rows / 512, 2 * 512), reading whole rows
// and writing each feature's columns coalesced. What bounds it is the L2's
// atomic unit, not the 54.5 MB of compulsory bytes (0.0163 ms): 4.19 M
// scattered sector updates at ~70 G/s. Measured 0.0669 ms, index_add_ (the
// same 4.19 M sector updates, as two scalar atomics of a row in one warp
// instruction) 0.081. Measured out: a bucketed design (a histogram by a, a
// pass writing (b, bf16 pair) records to per-bucket segments with one global
// atomic per bucket and block, then a block per bucket summing in shared
// memory) took 0.2024 ms: its 4.19 M scattered 8-byte record writes cost L2
// sector transactions as the atomics do, and a shared-memory f32 add is a
// compare-and-swap loop on this card (ATOMS.CAST.SPIN). The atomics reorder
// the f32 sums from run to run, so the result agrees with a sequential sum
// within 1e-6 x the largest summed magnitude, not to the bit; every index on
// one row serialises the atomics on one address and stays right.
//
// Times: CUDA-event medians of tools/microbench_gather.py at M = 2^22 on an
// NVIDIA H100 80GB HBM3 at 700 W, the card's work alone, warm (ms).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace insr {

constexpr int kProbeBlock = 256;

inline int probe_grid(long long work, int per_block) {
  const long long g = (work + per_block - 1) / per_block;
  return static_cast<int>(g > 0 ? (g < 2147483647LL ? g : 2147483647LL) : 1);
}

constexpr int kMaxDevices = 16;

// *blocks = the blocks of `kernel` (kProbeBlock threads, smem bytes of
// dynamic shared memory, allowed above 48 KB) resident on all SMs of the
// current device at once, worked out once per device into cache
inline cudaError_t resident_blocks(const void* kernel, int smem, int (&cache)[kMaxDevices],
                                   int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kProbeBlock, smem);
    }
    if (e != cudaSuccess) return e;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

// *grid = the resident blocks of `kernel` (no dynamic shared memory), or the
// blocks that `work` items at `per_block` items a block need, whichever is
// less, and at least one
inline cudaError_t persistent_grid(const void* kernel, long long work, int per_block,
                                   int (&cache)[kMaxDevices], int* grid) {
  int resident = 0;
  const cudaError_t e = resident_blocks(kernel, 0, cache, &resident);
  if (e != cudaSuccess) return e;
  const long long need = (work + per_block - 1) / per_block;
  *grid = static_cast<int>(need < resident ? (need > 0 ? need : 1) : resident);
  return cudaSuccess;
}

// unroll 1: a thread per index
__global__ void __launch_bounds__(kProbeBlock)
    scalar_gather(const int* __restrict__ idx, long long m,
                  const float2* __restrict__ table, float2* __restrict__ out) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < m) out[j] = __ldg(table + idx[j]);
}

constexpr int kGatherUnroll = 8;  // gathers a lane keeps in flight
constexpr int kGatherWarps = kProbeBlock / 32;
constexpr int kGatherChunk = kGatherUnroll * 32;  // indices of a warp's step

// unroll 8, on a persistent grid whose warps take equal contiguous spans of
// the indices (ceil(m / warps) rounded up to 32), in steps of 256: lane l
// takes j = step + u * 32 + l for u = 0..7, so that every index load (128
// bytes) and every float2 store (256 bytes) of a warp is coalesced and a
// lane's 8 gathers are in flight together. The next step's indices are
// loaded before the current step is stored; the streamed indices and output
// go through __ldcs / __stcs (evict first), which leaves the table's rows in
// L2
__global__ void __launch_bounds__(kProbeBlock)
    scalar_gather8(const int* __restrict__ idx, long long m,
                   const float2* __restrict__ table, float2* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kGatherWarps;
  const long long warp = static_cast<long long>(blockIdx.x) * kGatherWarps + (threadIdx.x >> 5);
  const long long span = ((m + warps - 1) / warps + 31) / 32 * 32;
  const long long begin = warp * span;
  const long long end = begin + span < m ? begin + span : m;
  int ix[kGatherUnroll];
  auto load = [&](long long b) {
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const long long j = b + u * 32 + lane;
      ix[u] = j < end ? __ldcs(idx + j) : 0;
    }
  };
  if (begin < end) load(begin);
  for (long long b = begin; b < end; b += kGatherChunk) {
    float2 v[kGatherUnroll];
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) v[u] = __ldg(table + ix[u]);
    if (b + kGatherChunk < end) load(b + kGatherChunk);
#pragma unroll
    for (int u = 0; u < kGatherUnroll; ++u) {
      const long long j = b + u * 32 + lane;
      if (j < end) __stcs(out + j, v[u]);
    }
  }
}

constexpr int kVecChunk = 8192;

__global__ void __launch_bounds__(kProbeBlock)
    vector_gather(const int* __restrict__ idx, long long m,
                  const float2* __restrict__ table, float2* __restrict__ out) {
  const long long start = static_cast<long long>(blockIdx.x) * kVecChunk;
  for (int k = threadIdx.x; k < kVecChunk; k += blockDim.x) {
    const long long j = start + k;
    if (j < m) out[j] = __ldg(table + idx[j]);
  }
}

// one warp per output row: lane l moves columns 4l .. 4l+3
__global__ void __launch_bounds__(kProbeBlock)
    row_gather(const int* __restrict__ idx, long long m, const float4* __restrict__ table,
               float4* __restrict__ out) {
  const long long j = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (j < m) out[j * 32 + lane] = __ldg(table + static_cast<long long>(idx[j]) * 32 + lane);
}

__global__ void __launch_bounds__(kProbeBlock)
    lane_gather(const int* __restrict__ idx, long long m, const float* __restrict__ lut,
                float* __restrict__ out) {
  __shared__ float s[128];
  if (threadIdx.x < 128) s[threadIdx.x] = lut[threadIdx.x];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < m;
       j += stride) {
    out[j] = s[idx[j]];
  }
}

constexpr int kSubRows = 512;
constexpr int kSubSlice = 32;  // columns of a block's table slice: one per lane
constexpr int kSubSlices = 128 / kSubSlice;
constexpr int kSubUnroll = 8;  // rows whose index loads a thread keeps in flight
constexpr int kSubWarps = kProbeBlock / 32;

// blockIdx.y picks the 32-column slice, kept in shared memory as (512, 32)
// f32 (64 KB); each warp walks groups of 8 rows, lane l on column c0 + l of
// each: 8 independent index loads in flight, then reads of bank l alone
// (word r * 32 + l), whatever the rows. The next group's indices are loaded
// before the current group is stored.
__global__ void __launch_bounds__(kProbeBlock)
    sublane_gather(const int* __restrict__ idx, long long rows,
                   const float* __restrict__ table, float* __restrict__ out) {
  extern __shared__ float4 slice4[];  // (512, 8) float4 = (512, 32) f32
  const float* slice = reinterpret_cast<const float*>(slice4);
  const int c0 = blockIdx.y * kSubSlice;
  const int lane = threadIdx.x & 31;
  const long long groups = (rows + kSubUnroll - 1) / kSubUnroll;
  const long long gstride = static_cast<long long>(gridDim.x) * kSubWarps;
  long long g = static_cast<long long>(blockIdx.x) * kSubWarps + (threadIdx.x >> 5);
  const int* ip = idx + c0 + lane;
  float* op = out + c0 + lane;
  int ix[kSubUnroll];
  auto load = [&](long long grp) {
#pragma unroll
    for (int u = 0; u < kSubUnroll; ++u) {
      const long long r = grp * kSubUnroll + u;
      ix[u] = r < rows ? __ldcs(ip + r * 128) : 0;
    }
  };
  if (g < groups) load(g);  // in flight while the slice is copied
  const float4* t4 = reinterpret_cast<const float4*>(table) + c0 / 4;
  for (int k = threadIdx.x; k < kSubRows * kSubSlice / 4; k += blockDim.x) {
    slice4[k] = __ldg(t4 + (k / (kSubSlice / 4)) * 32 + k % (kSubSlice / 4));
  }
  __syncthreads();
  for (; g < groups; g += gstride) {
    float v[kSubUnroll];
#pragma unroll
    for (int u = 0; u < kSubUnroll; ++u) v[u] = slice[ix[u] * kSubSlice + lane];
    const long long r0 = g * kSubUnroll;
    if (g + gstride < groups) load(g + gstride);
#pragma unroll
    for (int u = 0; u < kSubUnroll; ++u) {
      if (r0 + u < rows) __stcs(op + (r0 + u) * 128, v[u]);
    }
  }
}

constexpr int kOneHotB = 512;  // columns b of one feature block
constexpr int kOneHotF = 2;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one 8-byte vector atomic (REDG.E.ADD.F32x2) per update row
template <bool kRoundBf16>
__device__ __forceinline__ void add_row(float2* __restrict__ table, int row, float x, float y) {
  if constexpr (kRoundBf16) {
    x = bf16_round(x);
    y = bf16_round(y);
  }
  atomicAdd(table + row, make_float2(x, y));
}

// every update once, one 8-byte vector atomic into row idx of the zeroed
// row-major (rows, 2) f32 table; a step of a thread is four updates from one
// 16-byte index load and two 16-byte update loads, the last m % 4 one a
// thread. P1f adds the f32 updates into its output (kRoundBf16 false); P1g's
// pass 1 rounds each to bf16 first and adds into its scratch
template <bool kRoundBf16>
__global__ void __launch_bounds__(kProbeBlock)
    vector_scatter(const int* __restrict__ idx, long long m, const float2* __restrict__ upd,
                   float2* __restrict__ table) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long m4 = m / 4;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  const float4* upd4 = reinterpret_cast<const float4*>(upd);
  for (long long q = first; q < m4; q += stride) {
    const int4 ix = __ldcs(idx4 + q);
    const float4 w0 = __ldcs(upd4 + 2 * q);
    const float4 w1 = __ldcs(upd4 + 2 * q + 1);
    add_row<kRoundBf16>(table, ix.x, w0.x, w0.y);
    add_row<kRoundBf16>(table, ix.y, w0.z, w0.w);
    add_row<kRoundBf16>(table, ix.z, w1.x, w1.y);
    add_row<kRoundBf16>(table, ix.w, w1.z, w1.w);
  }
  for (long long j = m4 * 4 + first; j < m; j += stride) {
    const float2 w = upd[j];
    add_row<kRoundBf16>(table, idx[j], w.x, w.y);
  }
}

// pass 2: (rows, 2) scratch -> (rows / 512, 2 * 512) output, row r = a * 512
// + b to columns b and 512 + b of output row a: coalesced reads and writes
__global__ void __launch_bounds__(kProbeBlock)
    onehot_write(const float2* __restrict__ scratch, long long rows, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < rows;
       r += stride) {
    const float2 v = scratch[r];
    float* o = out + (r / kOneHotB) * (kOneHotF * kOneHotB) + r % kOneHotB;
    o[0] = v.x;
    o[kOneHotB] = v.y;
  }
}

constexpr int kP2Chunk = 4096;
constexpr int kP2Cols = 128;

// VARIANT 0: one accumulator; 1: eight accumulators; 2: rows stored to an
// 8-row shared scratch
template <int VARIANT>
__global__ void __launch_bounds__(kP2Cols)
    chunk_row_sum(const int* __restrict__ idx, const float* __restrict__ table,
                  float* __restrict__ out) {
  const int c = threadIdx.x;
  const int* ix = idx + static_cast<long long>(blockIdx.x) * kP2Chunk;
  float* o = out + static_cast<long long>(blockIdx.x) * 8 * kP2Cols;
  if constexpr (VARIANT == 0) {
    float acc = 0.0f;
    for (int i = 0; i < kP2Chunk; ++i) acc += __ldg(table + ix[i] * kP2Cols + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j * kP2Cols + c] = acc;
  } else if constexpr (VARIANT == 1) {
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < kP2Chunk; i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += __ldg(table + ix[i + j] * kP2Cols + c);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j * kP2Cols + c] = acc[j];
  } else {
    __shared__ float scratch[8 * kP2Cols];
    volatile float* sv = scratch;
    for (int i = 0; i < kP2Chunk; ++i) sv[(i % 8) * kP2Cols + c] = __ldg(table + ix[i] * kP2Cols + c);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j * kP2Cols + c] = sv[j * kP2Cols + c];
  }
}

}  // namespace insr

// Each entry point returns cudaGetLastError() after its launch, or -1 for a
// shape it does not take. Indices are int32 and must lie in range: the
// kernels do not check them (tools/microbench_gather.py draws them so).
extern "C" {

int probe_scalar_gather(const int* idx, long long m, const void* table, void* out, int unroll,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* t = static_cast<const float2*>(table);
  float2* o = static_cast<float2*>(out);
  if (unroll == 1) {
    insr::scalar_gather<<<insr::probe_grid(m, insr::kProbeBlock), insr::kProbeBlock, 0, st>>>(
        idx, m, t, o);
  } else if (unroll == 8) {
    static int cache[insr::kMaxDevices] = {};
    int grid = 0;
    const cudaError_t e = insr::persistent_grid(reinterpret_cast<const void*>(insr::scalar_gather8),
                                                m, insr::kGatherChunk * insr::kGatherWarps, cache,
                                                &grid);
    if (e != cudaSuccess) return static_cast<int>(e);
    insr::scalar_gather8<<<grid, insr::kProbeBlock, 0, st>>>(idx, m, t, o);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

int probe_vector_gather(const int* idx, long long m, const void* table, void* out,
                        void* stream) {
  insr::vector_gather<<<insr::probe_grid(m, insr::kVecChunk), insr::kProbeBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      idx, m, static_cast<const float2*>(table), static_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

int probe_row_gather(const int* idx, long long m, const void* table, void* out, void* stream) {
  insr::row_gather<<<insr::probe_grid(m * 32, insr::kProbeBlock), insr::kProbeBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      idx, m, static_cast<const float4*>(table), static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

int probe_lane_gather(const int* idx, long long m, const float* lut, float* out, void* stream) {
  const long long g = (m + insr::kProbeBlock - 1) / insr::kProbeBlock;
  insr::lane_gather<<<static_cast<int>(g < 4096 ? (g > 0 ? g : 1) : 4096), insr::kProbeBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(idx, m, lut, out);
  return static_cast<int>(cudaGetLastError());
}

int probe_sublane_gather(const int* idx, long long rows, const float* table, float* out,
                         void* stream) {
  if (reinterpret_cast<uintptr_t>(table) % 16) return -1;
  if (rows == 0) return 0;
  constexpr int smem = sizeof(float) * insr::kSubRows * insr::kSubSlice;
  static int cache[insr::kMaxDevices] = {};
  int resident = 0;
  const cudaError_t e = insr::resident_blocks(
      reinterpret_cast<const void*>(insr::sublane_gather), smem, cache, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  // a persistent grid: every resident block over the four slices, no more
  // blocks than groups of 8 rows for their 8 warps
  const long long need = (rows + insr::kSubUnroll * insr::kSubWarps - 1) /
                         (insr::kSubUnroll * insr::kSubWarps);
  const long long gx = resident / insr::kSubSlices;
  dim3 grid(static_cast<unsigned>(need < gx ? need : (gx > 0 ? gx : 1)), insr::kSubSlices);
  insr::sublane_gather<<<grid, insr::kProbeBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, rows, table, out);
  return static_cast<int>(cudaGetLastError());
}

// out: the (rows, 2) f32 table, zeroed by the caller; idx, upd and out
// 16-byte aligned
int probe_scatter_add(const int* idx, long long m, const void* upd, float* out, void* stream) {
  if (reinterpret_cast<uintptr_t>(idx) % 16 || reinterpret_cast<uintptr_t>(upd) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return -1;
  }
  static int cache[insr::kMaxDevices] = {};
  int grid = 0;
  const cudaError_t e = insr::persistent_grid(
      reinterpret_cast<const void*>(insr::vector_scatter<false>), m / 4, insr::kProbeBlock, cache,
      &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  insr::vector_scatter<false><<<grid, insr::kProbeBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, m, static_cast<const float2*>(upd), reinterpret_cast<float2*>(out));
  return static_cast<int>(cudaGetLastError());
}

// scratch: a (table_rows, 2) f32 table zeroed by the caller; idx and wg
// 16-byte aligned
int probe_onehot_grad(const int* idx, long long m, const void* wg, int table_rows, float* out,
                      float* scratch, void* stream) {
  if (table_rows % insr::kOneHotB || reinterpret_cast<uintptr_t>(idx) % 16 ||
      reinterpret_cast<uintptr_t>(wg) % 16 || reinterpret_cast<uintptr_t>(scratch) % 16) {
    return -1;
  }
  static int cache[insr::kMaxDevices] = {};
  int grid = 0;
  const cudaError_t e = insr::persistent_grid(
      reinterpret_cast<const void*>(insr::vector_scatter<true>), m / 4, insr::kProbeBlock, cache,
      &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* s2 = reinterpret_cast<float2*>(scratch);
  if (m > 0) {
    insr::vector_scatter<true><<<grid, insr::kProbeBlock, 0, st>>>(
        idx, m, static_cast<const float2*>(wg), s2);
  }
  const int write_grid = insr::probe_grid(table_rows, insr::kProbeBlock);
  insr::onehot_write<<<write_grid, insr::kProbeBlock, 0, st>>>(s2, table_rows, out);
  return static_cast<int>(cudaGetLastError());
}

int probe_chunk_row_sum(const int* idx, long long m, const float* table, float* out,
                        int variant, void* stream) {
  if (m % insr::kP2Chunk) return -1;
  const int grid = static_cast<int>(m / insr::kP2Chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid == 0) return 0;
  switch (variant) {
    case 0: insr::chunk_row_sum<0><<<grid, insr::kP2Cols, 0, st>>>(idx, table, out); break;
    case 1: insr::chunk_row_sum<1><<<grid, insr::kP2Cols, 0, st>>>(idx, table, out); break;
    case 2: insr::chunk_row_sum<2><<<grid, insr::kP2Cols, 0, st>>>(idx, table, out); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
