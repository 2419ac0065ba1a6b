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
//       8,192-index chunk, its warps in P1a unroll 8's coalesced steps (below)
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
//       table in 4,096-index chunks: (a) one accumulator per chunk, written
//       to its 8 output rows; (b) eight accumulators, row j summing the
//       indices i = j mod 8; (c) every row stored to an 8-row scratch at i
//       mod 8, whose last contents are the output. (a) and (b) stage the
//       table in shared memory in column slabs (chunk_slab_sum); (c) reads
//       only the rows its output keeps (chunk_last_rows). Notes below.
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
// P1b: the same function as P1a, bound the same way (the L2's sector rate:
// 4.19 M random table sectors at M = 2^22). A first design, a block per
// 8,192-index chunk with one gather in flight a thread per iteration, plain
// stores and no cache hints, took 0.0426 ms. Here the block keeps the TPU
// kernel's 8,192-index chunk and its 8 warps walk 1,024 consecutive indices
// each in P1a unroll 8's coalesced steps (gather_span): 0.0405 ms,
// index_select 0.0432. Measured and dropped: the table in the distributed
// shared memory of clusters of 16 blocks (16 x 232,432 bytes, 89% of the 4
// MB table, the rest from L2), each random 8-byte row read from the SM that
// holds it: 0.0692-0.0701 ms; the SM-to-SM network serves these reads
// slower than L2 does.
//
// P2a / P2b: the compulsory bytes are the 4 MB indices, the 4 MB table once
// and the 1 MB output (0.0028 ms at 3.35 TB/s), but every index reads a
// whole 512-byte row: 512 MB of row reads. A first design (a block of 128
// threads per chunk, a thread a column: 8 warps an SM, every row read from
// L2, every thread reloading every index, P2a one chain of dependent adds)
// took 0.1211-0.1216 / 0.1610-0.1611 ms, about 4 TB/s of L2 reads.
// chunk_slab_sum moves the row reads into shared memory: a block stages one
// 4-column slab of the table (rows x 16 B, 128 KB at 8,192 rows) once, the
// grid is one wave of (32 slabs) x (ranges of chunks), one block an SM, and
// 16 warps each walk their own chunks. A warp's lanes are (i mod 8, column):
// lane 4 j + c adds column c of the rows of the indices i = j mod 8, so
// P2b's eight accumulators are the eight lane groups, summed in the TPU
// kernel's order, and P2a folds them at the chunk's end (xor 16, 8, 4: ((a0
// + a4) + (a2 + a6)) + ((a1 + a5) + (a3 + a7)), the one change of order). A
// warp step's 8 indices are one 32-byte sector, loaded with __ldg, the next
// 8 steps' in flight; a chunk's 16 KB of indices is bulk-prefetched into L2
// (cp.async.bulk.prefetch.L2) one chunk ahead by one of the 32 slabs'
// blocks: 0.0716-0.0720 ms warm, 0.0781-0.0786 with a cold L2. What bounds
// it is the shared-memory pipe: a step of a warp is two loads, one of the
// indices (one wavefront) and one row read of 8 rows x 4 columns whose rows
// fall on random 4-bank groups (row mod 8), as many wavefronts as the most
// rows sharing a group, 2.60 a step on random rows
// (tools/microbench_gather.py p2_row_wavefronts); on indices without
// conflicts (row mod 8 = i mod 8) P2b takes 0.0596. No layout of the slab
// spreads random rows better: a row's 4 words on one 4-bank group is 8 rows
// into 8 groups; any other placement is 32 words into 32 banks, worse.
// Measured and dropped: the indices as 256-index pieces, four in flight a
// warp, by cp.async.bulk into a per-warp ring of mbarrier stages
// (0.0796-0.0800 warm, 0.0832-0.0837 cold, 0.0549 conflict-free); that ring
// with each piece multicast to a cluster of 4 or 8 blocks (0.1012-0.1027);
// one index load per 4 steps handed on by shuffles (0.0830); plain loads
// without the prefetch (0.0718-0.0721 warm, but 0.1325-0.1331 cold: 8
// steps' loads in flight do not hide HBM's latency); the prefetch issued by
// all 32 slabs' blocks (0.0777-0.0778 warm, 128 MB of redundant prefetches);
// 16 steps' loads in flight (0.0771-0.0775).
//
// P2c: the TPU kernel stores every row of a chunk into scratch row i mod 8,
// so only the chunk's last 8 rows survive; the store walk does not change
// its output. chunk_last_rows reads those 8 indices and rows of each chunk
// and nothing else: a warp an output row, a float4 a lane, streaming
// stores; bound by its launch at the JAX script's size (2 MB of data):
// 0.0027 ms (0.1988-0.1999 for the first design, which walked every row).
//
// Times: CUDA-event medians of tools/microbench_gather.py at M = 2^22 on an
// NVIDIA H100 80GB HBM3 at 700 W, the card's work alone, warm unless marked
// cold (ms).
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

// *blocks = the blocks of `kernel` (`threads` threads, smem bytes of
// dynamic shared memory, allowed above 48 KB) resident on all SMs of the
// current device at once, worked out once per device into cache
inline cudaError_t resident_blocks(const void* kernel, int smem, int (&cache)[kMaxDevices],
                                   int* blocks, int threads = kProbeBlock) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
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

// a warp's gathers of indices [begin, end) in steps of 256: lane l takes j =
// step + u * 32 + l for u = 0..7, so that every index load (128 bytes) and
// every float2 store (256 bytes) of a warp is coalesced and a lane's 8
// gathers are in flight together. The next step's indices are loaded before
// the current step is stored; the streamed indices and output go through
// __ldcs / __stcs (evict first), which leaves the table's rows in L2
__device__ __forceinline__ void gather_span(const int* __restrict__ idx,
                                            const float2* __restrict__ table,
                                            float2* __restrict__ out, long long begin,
                                            long long end, int lane) {
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

// unroll 8, on a persistent grid whose warps take equal contiguous spans of
// the indices (ceil(m / warps) rounded up to 32)
__global__ void __launch_bounds__(kProbeBlock)
    scalar_gather8(const int* __restrict__ idx, long long m,
                   const float2* __restrict__ table, float2* __restrict__ out) {
  const long long warps = static_cast<long long>(gridDim.x) * kGatherWarps;
  const long long warp = static_cast<long long>(blockIdx.x) * kGatherWarps + (threadIdx.x >> 5);
  const long long span = ((m + warps - 1) / warps + 31) / 32 * 32;
  const long long begin = warp * span;
  gather_span(idx, table, out, begin, begin + span < m ? begin + span : m, threadIdx.x & 31);
}

constexpr int kVecChunk = 8192;
constexpr int kVecWarpSpan = kVecChunk / kGatherWarps;  // 1,024 indices: 4 steps of a warp

// P1b: a block per 8,192-index chunk, its warp w on the chunk's indices
// [1024 w, 1024 (w + 1))
__global__ void __launch_bounds__(kProbeBlock)
    vector_gather(const int* __restrict__ idx, long long m, const float2* __restrict__ table,
                  float2* __restrict__ out) {
  const long long begin = static_cast<long long>(blockIdx.x) * kVecChunk +
                          (threadIdx.x >> 5) * kVecWarpSpan;
  const long long end = begin + kVecWarpSpan < m ? begin + kVecWarpSpan : m;
  gather_span(idx, table, out, begin, end, threadIdx.x & 31);
}

// -- asynchronous copies (PTX: cp.async of sm_80, the bulk prefetch of sm_90)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// starts bringing `bytes` (a multiple of 16, src 16-byte aligned) of global
// memory into L2, without waiting
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src), "r"(bytes) : "memory");
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
constexpr int kP2MaxRows = 8192;
constexpr int kP2SlabCols = 4;                      // columns of a block's slab
constexpr int kP2Slabs = kP2Cols / kP2SlabCols;     // 32: blockIdx.x
constexpr int kP2Warps = 16;                        // each walks its own chunks
constexpr int kP2Unroll = 8;                        // steps whose index loads are in flight

// P2a (fold) / P2b: block (s, y) stages column slab s of the table, rows x
// 4 floats, in shared memory and sums the chunks of range y, chunk by chunk,
// its warp w taking the range's chunks w, w + 16, ...; lane 4 j + c adds
// column 4 s + c of the rows of the chunk's indices i = j mod 8, in the
// order of i. A step of a warp is 8 consecutive indices (one 32-byte
// sector, lane 4 j + c loading index j); the next 8 steps' indices are
// loaded while the current 8 steps read the slab.
__global__ void __launch_bounds__(kP2Warps * 32, 1)
    chunk_slab_sum(const int* __restrict__ idx, int chunks, const float* __restrict__ table,
                   int rows, float* __restrict__ out, int per_block, int fold) {
  extern __shared__ float4 slab[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x;
  const int begin = blockIdx.y * per_block;
  const int end = begin + per_block < chunks ? begin + per_block : chunks;
  // a chunk's indices are prefetched into L2 once, by one of the 32 slabs'
  // blocks (slab chunk mod 32), which run side by side in the one wave
  auto prefetch = [&](long long chunk) {
    if (lane == 0 && chunk < end && chunk % kP2Slabs == s) {
      prefetch_l2(idx + chunk * kP2Chunk, kP2Chunk * 4);
    }
  };
  prefetch(begin + warp);
  // the slab: 16 bytes of each row
  const float4* t4 = reinterpret_cast<const float4*>(table) + s;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) cp_async16(slab + r, t4 + r * kP2Slabs);
  cp_async_wait_all();
  __syncthreads();
  const float* sf = reinterpret_cast<const float*>(slab);
  const int j = lane >> 2, c = lane & 3;
  for (long long chunk = begin + warp; chunk < end; chunk += kP2Warps) {
    prefetch(chunk + kP2Warps);  // the warp's next chunk, while this one is summed
    const int* ci = idx + chunk * kP2Chunk + j;
    int r[kP2Unroll];
#pragma unroll
    for (int u = 0; u < kP2Unroll; ++u) r[u] = __ldg(ci + u * 8);
    float acc = 0.0f;
    for (int q = 0; q < kP2Chunk / 8; q += kP2Unroll) {
      float v[kP2Unroll];
#pragma unroll
      for (int u = 0; u < kP2Unroll; ++u) v[u] = sf[r[u] * kP2SlabCols + c];
      if (q + kP2Unroll < kP2Chunk / 8) {
#pragma unroll
        for (int u = 0; u < kP2Unroll; ++u) r[u] = __ldg(ci + (q + kP2Unroll + u) * 8);
      }
#pragma unroll
      for (int u = 0; u < kP2Unroll; ++u) acc += v[u];
    }
    if (fold) {
      acc += __shfl_xor_sync(0xffffffffu, acc, 16);
      acc += __shfl_xor_sync(0xffffffffu, acc, 8);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    }
    __stcs(out + (chunk * 8 + j) * kP2Cols + s * kP2SlabCols + c, acc);
  }
}

// P2c: output row g = 8 k + t is the row of index 4088 + t of chunk k; a warp
// a row, a float4 a lane
__global__ void __launch_bounds__(kProbeBlock)
    chunk_last_rows(const int* __restrict__ idx, long long out_rows,
                    const float4* __restrict__ table, float4* __restrict__ out) {
  const long long g = (static_cast<long long>(blockIdx.x) * kProbeBlock + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= out_rows) return;
  const int r = __ldg(idx + (g >> 3) * kP2Chunk + kP2Chunk - 8 + (g & 7));
  __stcs(out + g * (kP2Cols / 4) + lane,
         __ldg(table + static_cast<long long>(r) * (kP2Cols / 4) + lane));
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
  if (m > 0) {
    insr::vector_gather<<<insr::probe_grid(m, insr::kVecChunk), insr::kProbeBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        idx, m, static_cast<const float2*>(table), static_cast<float2*>(out));
  }
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

// variant 0: P2a, 1: P2b (chunk_slab_sum), 2: P2c (chunk_last_rows); m a
// multiple of 4,096, a (rows, 128) table with rows <= 8,192, idx and table
// 16-byte aligned
int probe_chunk_row_sum(const int* idx, long long m, const float* table, int rows, float* out,
                        int variant, void* stream) {
  if (m % insr::kP2Chunk || rows < 1 || rows > insr::kP2MaxRows || variant < 0 || variant > 2 ||
      m / insr::kP2Chunk > 2147483647LL || reinterpret_cast<uintptr_t>(idx) % 16 ||
      reinterpret_cast<uintptr_t>(table) % 16) {
    return -1;
  }
  const long long chunks = m / insr::kP2Chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunks == 0) return 0;
  if (variant == 2) {
    insr::chunk_last_rows<<<static_cast<int>(chunks), insr::kProbeBlock, 0, st>>>(
        idx, chunks * 8, reinterpret_cast<const float4*>(table), reinterpret_cast<float4*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int kThreads = insr::kP2Warps * 32;
  constexpr int kMaxSmem = insr::kP2MaxRows * 16;
  static int cache[insr::kMaxDevices] = {};
  int resident = 0;
  const cudaError_t e = insr::resident_blocks(reinterpret_cast<const void*>(insr::chunk_slab_sum),
                                              kMaxSmem, cache, &resident, kThreads);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one wave: the 32 slabs times as many chunk ranges as resident blocks allow
  long long ranges = resident / insr::kP2Slabs;
  ranges = ranges < 1 ? 1 : (ranges > chunks ? chunks : ranges);
  const long long per_block = (chunks + ranges - 1) / ranges;
  const dim3 grid(insr::kP2Slabs, static_cast<unsigned>((chunks + per_block - 1) / per_block));
  insr::chunk_slab_sum<<<grid, kThreads, rows * 16, st>>>(
      idx, static_cast<int>(chunks), table, rows, out, static_cast<int>(per_block),
      variant == 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
