// The gather and scatter probes P1a-P1g and P2: small kernels that measure
// the hash grid's two memory patterns on the card, random table gathers (its
// forward, HG1) and the scatter-add of its table gradient (HG2).
//
// Replaces the eight pallas_calls of the JAX package's probe scripts, each
// computing the same function:
//   P1a scripts/microbench_pallas.py:156 (pallas_scalar_gather, :143):
//       out[j] = table[idx[j]] over a (2^19, 2) f32 table; a thread per index
//       (UNROLL 1) or per 8 consecutive indices (UNROLL 8), one 8-byte load
//   P1b :201 (bench_pallas_vector_gather, :191): the same gather, a block per
//       8,192-index chunk
//   P1c :237 (bench_pallas_takealong_col, :225): whole 128-wide rows of a
//       (2^19, 128) f32 table, a warp per row, 16-byte loads
//   P1d :273 (bench_pallas_lane_gather, :261): out[r, c] = lut[idx[r, c]] of
//       a 128-entry lookup table (row 0 of the (8, 128) table) kept in shared
//       memory
//   P1e :311 (bench_pallas_sublane_gather, :297): out[r, c] = table[idx[r, c],
//       c] of a (512, 128) table; a block keeps a 64-column slice (128 KB) in
//       shared memory
//   P1f :359 (pallas_scatter_add, :340): scatter-add of (M, 2) f32 updates
//       into a zeroed (2^19, 2) table with float32 atomicAdd
//   P1g :419 (pallas_onehot_grad, :396): the same gradient as the TPU's
//       one-hot products U^T (W * g): rows split as (a, b) = (row / 512, row %
//       512), each update rounded to bf16, sums in f32, output (T / 512, 512 *
//       F) with feature j in columns j*512 .. j*512+511. A block owns 8 rows a
//       of the output in shared memory, reads the whole index stream and adds
//       the updates whose a it owns (shared-memory atomics); tensor cores are
//       a later step
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
// one float32 atomic per value (P1f) or per value and shared-memory tile
// (P1g). The bounds are computed in tools/microbench_gather.py from each
// run's data.
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

template <int UNROLL>
__global__ void __launch_bounds__(kProbeBlock)
    scalar_gather(const int* __restrict__ idx, long long m,
                  const float2* __restrict__ table, float2* __restrict__ out) {
  const long long base =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * UNROLL;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long j = base + u;
    if (j < m) out[j] = __ldg(table + idx[j]);
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
constexpr int kSubCols = 64;  // columns of the table a block keeps in shared memory

// blockIdx.y picks the 64-column slice; rows of the (rows, 128) output are
// walked by a grid stride, a thread per (row, column of the slice)
__global__ void __launch_bounds__(kProbeBlock)
    sublane_gather(const int* __restrict__ idx, long long rows,
                   const float* __restrict__ table, float* __restrict__ out) {
  extern __shared__ float tab_s[];  // (512, 64)
  const int c0 = blockIdx.y * kSubCols;
  for (int k = threadIdx.x; k < kSubRows * kSubCols; k += blockDim.x) {
    tab_s[k] = table[(k / kSubCols) * 128 + c0 + k % kSubCols];
  }
  __syncthreads();
  const long long total = rows * kSubCols;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < total; k += stride) {
    const long long r = k / kSubCols;
    const int c = static_cast<int>(k % kSubCols);
    const long long o = r * 128 + c0 + c;
    out[o] = tab_s[idx[o] * kSubCols + c];
  }
}

__global__ void __launch_bounds__(kProbeBlock)
    scatter_add(const int* __restrict__ idx, long long m, const float2* __restrict__ upd,
                float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; j < m;
       j += stride) {
    const float2 u = upd[j];
    float* row = out + 2LL * idx[j];
    atomicAdd(row, u.x);
    atomicAdd(row + 1, u.y);
  }
}

constexpr int kOneHotB = 512;   // columns b of one feature block
constexpr int kOneHotRows = 8;  // rows a of the output a block owns
constexpr int kOneHotF = 2;

__global__ void __launch_bounds__(kProbeBlock)
    onehot_grad(const int* __restrict__ idx, long long m, const float2* __restrict__ wg,
                int adim, float* __restrict__ out) {
  __shared__ float acc[kOneHotRows * kOneHotF * kOneHotB];  // 32 KB
  const int a0 = blockIdx.x * kOneHotRows;
  for (int k = threadIdx.x; k < kOneHotRows * kOneHotF * kOneHotB; k += blockDim.x) acc[k] = 0.0f;
  __syncthreads();
  for (long long j = threadIdx.x; j < m; j += blockDim.x) {
    const int row = idx[j];
    const int a = row / kOneHotB - a0;
    if (a >= 0 && a < kOneHotRows) {
      const int b = row % kOneHotB;
      const float2 g = wg[j];
      float* dst = acc + a * kOneHotF * kOneHotB + b;
      atomicAdd(dst, __bfloat162float(__float2bfloat16_rn(g.x)));
      atomicAdd(dst + kOneHotB, __bfloat162float(__float2bfloat16_rn(g.y)));
    }
  }
  __syncthreads();
  const int rows = min(kOneHotRows, adim - a0);
  for (int k = threadIdx.x; k < rows * kOneHotF * kOneHotB; k += blockDim.x) {
    out[static_cast<long long>(a0) * kOneHotF * kOneHotB + k] = acc[k];
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
    insr::scalar_gather<1><<<insr::probe_grid(m, insr::kProbeBlock), insr::kProbeBlock, 0, st>>>(
        idx, m, t, o);
  } else if (unroll == 8) {
    insr::scalar_gather<8><<<insr::probe_grid(m, 8 * insr::kProbeBlock), insr::kProbeBlock, 0,
                             st>>>(idx, m, t, o);
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
  const size_t smem = sizeof(float) * insr::kSubRows * insr::kSubCols;
  cudaError_t e = cudaFuncSetAttribute(insr::sublane_gather,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long g = (rows * insr::kSubCols + insr::kProbeBlock - 1) / insr::kProbeBlock;
  dim3 grid(static_cast<unsigned>(g < 132 ? (g > 0 ? g : 1) : 132), 128 / insr::kSubCols);
  insr::sublane_gather<<<grid, insr::kProbeBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      idx, rows, table, out);
  return static_cast<int>(cudaGetLastError());
}

int probe_scatter_add(const int* idx, long long m, const void* upd, float* out, void* stream) {
  const long long g = (m + insr::kProbeBlock - 1) / insr::kProbeBlock;
  insr::scatter_add<<<static_cast<int>(g < 8192 ? (g > 0 ? g : 1) : 8192), insr::kProbeBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(idx, m,
                                                           static_cast<const float2*>(upd), out);
  return static_cast<int>(cudaGetLastError());
}

int probe_onehot_grad(const int* idx, long long m, const void* wg, int table_rows, float* out,
                      void* stream) {
  if (table_rows % insr::kOneHotB) return -1;
  const int adim = table_rows / insr::kOneHotB;
  insr::onehot_grad<<<(adim + insr::kOneHotRows - 1) / insr::kOneHotRows, insr::kProbeBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      idx, m, static_cast<const float2*>(wg), adim, out);
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
