// HG1: the multiresolution hash-grid encoding forward.
//
// Replaces: instant_nsr_pl_tpu/ops/hashgrid.py hashgrid_encode_fast's forward
// (_encode_with_taps, :584-620), which is XLA, not Pallas: per level it builds
// (8, N) indices and weights and gathers (F, 8, N) table rows with jnp.take,
// and saves all three for its backward. Here one thread per sample walks the
// levels; for each it hashes (or strides) the 8 corners (hashgrid_common.cuh),
// reads the F features of each corner from the feature-major (F, T) float32
// table and sums them in corner order 0..7 as fmaf after the first product,
// as the JAX package's jitted code contracts the sum and the plain version
// (ops/hashgrid.py _corner_sum) computes it, then multiplies by the optional
// level mask: the output equals the plain version's to the bit. Output (N, L*F) float32, level-major. Nothing is
// saved for the backward: HG2 recomputes the taps.
//
// What bounds it on an H100: memory, as scattered reads. The compulsory bytes
// are x (12 B) and the output (L*F*4 = 128 B at the bench shape) per sample
// plus the table once (50.4 MB at 16 levels, 2^19 rows, F = 2): 0.026 ms for
// 262,144 samples at 3.35 TB/s. The hashed levels' corners land on random
// rows, so each corner costs a 32-byte sector per feature row (F = 2 rows of
// the (F, T) layout): 11 hashed levels x 8 corners x 2 sectors x 32 B = 5.6 KB
// per sample, 1.48 GB for 262,144 samples, 0.44 ms at 3.35 TB/s if none of it
// hit in the 50 MB L2 (the table is about the L2's size, so part does). The
// dense levels' corners are neighbours for neighbouring samples of a ray.
// A warp handles 32 samples of one level at a time, so its reads of a coarse
// level share cache lines. The output stores are 8-byte per level and thread,
// strided by 128 B across the warp; L2 merges the sectors over the levels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "hashgrid_common.cuh"

namespace insr {

template <int F>
__global__ void __launch_bounds__(kHashBlock)
    hashgrid_fwd_kernel(const float* __restrict__ x, long long n,
                        const float* __restrict__ table, long long total, int n_levels,
                        HashLevels levels, const float* __restrict__ mask,
                        float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x0 = x[3 * i], x1 = x[3 * i + 1], x2 = x[3 * i + 2];
    float* orow = out + i * n_levels * F;
    for (int l = 0; l < n_levels; ++l) {
      const Taps t = level_taps(levels.l[l], x0, x1, x2);
      float acc[F];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float v = __ldg(table + f * total + t.row[c]);
          acc[f] = c == 0 ? v * t.w[c] : fmaf(v, t.w[c], acc[f]);
        }
      }
      const float m = mask != nullptr ? mask[l] : 1.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) orow[l * F + f] = mask != nullptr ? acc[f] * m : acc[f];
    }
  }
}

template <int F>
int launch_hashgrid_fwd(const float* x, long long n, const float* table, long long total,
                        int n_levels, const HashLevels& levels, const float* mask, float* out,
                        cudaStream_t stream) {
  if (n > 0) {
    hashgrid_fwd_kernel<F><<<hash_grid_for(n), kHashBlock, 0, stream>>>(
        x, n, table, total, n_levels, levels, mask, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches (F not in {1, 2, 4, 8}, or too many levels). `levels` holds
// n_levels HashLevel records; mask is nullptr or (n_levels,) float32.
extern "C" int hashgrid_fwd(const float* x, long long n, const float* table,
                            long long total, int n_levels, int f,
                            const insr::HashLevel* levels, const float* mask, float* out,
                            void* stream) {
  if (n_levels < 1 || n_levels > insr::kHashMaxLevels) return -1;
  insr::HashLevels lv{};
  for (int l = 0; l < n_levels; ++l) lv.l[l] = levels[l];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 1: return insr::launch_hashgrid_fwd<1>(x, n, table, total, n_levels, lv, mask, out, st);
    case 2: return insr::launch_hashgrid_fwd<2>(x, n, table, total, n_levels, lv, mask, out, st);
    case 4: return insr::launch_hashgrid_fwd<4>(x, n, table, total, n_levels, lv, mask, out, st);
    case 8: return insr::launch_hashgrid_fwd<8>(x, n, table, total, n_levels, lv, mask, out, st);
    default: return -1;
  }
}
