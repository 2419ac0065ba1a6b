// HG1: the multiresolution hash-grid encoding forward.
//
// Replaces: instant_nsr_pl_tpu/ops/hashgrid.py hashgrid_encode_fast's forward
// (_encode_with_taps, :584-620), which is XLA, not Pallas: per level it builds
// (8, N) indices and weights and gathers (F, 8, N) table rows with jnp.take,
// and saves all three for its backward. Here a thread takes one sample and a
// group of LG consecutive levels; for each level it hashes (or strides) the 8
// corners (hashgrid_common.cuh), reads each corner's F features as one vector
// load from the row-major (T, F) float32 table and sums them in corner order
// 0..7 as fmaf after the first product, as the JAX package's jitted code
// contracts the sum and the plain version (ops/hashgrid.py _corner_sum)
// computes it, then multiplies by the optional level mask: the output equals
// the plain version's to the bit. Output (N, L*F) float32, level-major.
// Nothing is saved for the backward: HG2 recomputes the taps.
//
// What bounds it on an H100: scattered reads of the table. The compulsory
// bytes are x (12 B) and the output (L*F*4 = 128 B at the bench shape) per
// sample plus the table once (50.4 MB at 16 levels, 2^19 rows, F = 2): 0.026
// ms for 262,144 samples at 3.35 TB/s. The hashed levels' corners land on
// random rows, and a row of the (T, F) table is one 8-byte piece of one
// 32-byte sector: 11 hashed levels x 8 corners x 32 B = 2.8 KB of sectors per
// sample, 0.22 ms for 262,144 samples at 3.35 TB/s if none hit in L2 (the
// feature-major (F, T) layout of the JAX package costs two sectors a corner).
// Every gather of an L2-resident table runs at one sector rate (the probe P1a),
// so the design keeps the table's working set in L2 and reads fewer sectors:
// - level-major schedule: blockIdx.y is the level group, blockIdx.x the
//   samples, and blocks start in x-then-y order, so the card works through
//   the levels one group at a time: the working set is one group's slice of
//   the table (4 MB a hashed level), not the whole 50 MB table at once;
// - the (T, F) table: one sector a corner instead of F;
// - each thread stores its LG levels' LG*F floats as vector stores; the
//   output sector of a sample (32 B: 4 levels at F = 2) is completed by the
//   level groups that follow within a few microseconds, while it is in L2.
// The dense levels' corners are neighbours for neighbouring samples of a ray.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "hashgrid_common.cuh"

namespace insr {

// Store M floats to dst: float4 / float2 pieces when M allows them (the
// caller passes a dst aligned to 4 * M bytes, up to 16).
template <int M>
__device__ __forceinline__ void store_vec(float* __restrict__ dst, const float (&v)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int k = 0; k < M; k += 4) {
      reinterpret_cast<float4*>(dst)[k / 4] = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    }
  } else if constexpr (M % 2 == 0) {
#pragma unroll
    for (int k = 0; k < M; k += 2) {
      reinterpret_cast<float2*>(dst)[k / 2] = make_float2(v[k], v[k + 1]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < M; ++k) dst[k] = v[k];
  }
}

template <int F, int LG>
__global__ void __launch_bounds__(kHashBlock)
    hashgrid_fwd_kernel(const float* __restrict__ x, long long n,
                        const float* __restrict__ table, int n_levels, HashLevels levels,
                        const float* __restrict__ mask, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int l0 = blockIdx.y * LG;
  const float x0 = x[3 * i], x1 = x[3 * i + 1], x2 = x[3 * i + 2];
  float res[LG * F];
#pragma unroll
  for (int q = 0; q < LG; ++q) {
    const Taps t = level_taps(levels.l[l0 + q], x0, x1, x2);
    float acc[F];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v[F];
      load_row<F>(table, t.row[c], v);
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = c == 0 ? v[f] * t.w[c] : fmaf(v[f], t.w[c], acc[f]);
    }
    const float m = mask != nullptr ? mask[l0 + q] : 1.0f;
#pragma unroll
    for (int f = 0; f < F; ++f) res[q * F + f] = mask != nullptr ? acc[f] * m : acc[f];
  }
  store_vec<LG * F>(out + i * n_levels * F + l0 * F, res);
}

template <int F, int LG>
int launch_hashgrid_fwd(const float* x, long long n, const float* table, int n_levels,
                        const HashLevels& levels, const float* mask, float* out,
                        cudaStream_t stream) {
  if (n > 0) {
    const dim3 grid(static_cast<unsigned>((n + kHashBlock - 1) / kHashBlock), n_levels / LG);
    hashgrid_fwd_kernel<F, LG><<<grid, kHashBlock, 0, stream>>>(x, n, table, n_levels, levels,
                                                               mask, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Levels per thread: 4 where the level count allows it (then a thread's
// output at F = 2 is one whole 32-byte sector, two float4 stores), else 2 or
// 1. Measured at the bench shape (tools/bwd_bench.py --cuts): 4 levels a
// thread beat 2 and 1, and one launch beat four launches on quarters of N.
template <int F>
int launch_hashgrid_fwd_any(const float* x, long long n, const float* table, int n_levels,
                            const HashLevels& levels, const float* mask, float* out,
                            cudaStream_t stream) {
  const int group = n_levels % 4 == 0 ? 4 : n_levels % 2 == 0 ? 2 : 1;
  switch (group) {
    case 4: return launch_hashgrid_fwd<F, 4>(x, n, table, n_levels, levels, mask, out, stream);
    case 2: return launch_hashgrid_fwd<F, 2>(x, n, table, n_levels, levels, mask, out, stream);
    default: return launch_hashgrid_fwd<F, 1>(x, n, table, n_levels, levels, mask, out, stream);
  }
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches (F not in {1, 2, 4, 8}, or too many levels). table is the
// row-major (total, F) float32 table; `levels` holds n_levels HashLevel
// records; mask is nullptr or (n_levels,) float32.
extern "C" int hashgrid_fwd(const float* x, long long n, const float* table, int n_levels,
                            int f, const insr::HashLevel* levels, const float* mask, float* out,
                            void* stream) {
  if (n_levels < 1 || n_levels > insr::kHashMaxLevels) return -1;
  insr::HashLevels lv{};
  for (int l = 0; l < n_levels; ++l) lv.l[l] = levels[l];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_HG_FWD(F_) \
  return insr::launch_hashgrid_fwd_any<F_>(x, n, table, n_levels, lv, mask, out, st)
  switch (f) {
    case 1: INSR_HG_FWD(1);
    case 2: INSR_HG_FWD(2);
    case 4: INSR_HG_FWD(4);
    case 8: INSR_HG_FWD(8);
    default: return -1;
  }
#undef INSR_HG_FWD
}
