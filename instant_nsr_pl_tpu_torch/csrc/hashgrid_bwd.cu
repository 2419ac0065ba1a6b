// HG2: the hash-grid encoding's table gradient, and its position gradient on
// request.
//
// Replaces: instant_nsr_pl_tpu/ops/hashgrid.py _encode_fast_bwd (:652-737),
// XLA, not Pallas: from the forward's saved taps it forms per level the 8*N
// updates w_c * ct and sums them into the table gradient with a two-sort
// segment sum (ops/segment.py, levels of >= 2^17 rows) or bf16 one-hot
// matmuls with f32 sums (smaller levels), because the TPU has no fast scatter;
// the position gradient is _level_dx (:635-650). Here one thread per sample
// walks the levels, recomputes its 8 taps (hashgrid_common.cuh) and adds
// w_c * ct_l[f] * mask_l to row c of feature f of the (F, T) float32 gradient
// with a float32 atomicAdd, tiny-cuda-nn's scheme. With dx requested it also
// reads the 8 rows again and sums dL/dx_d = s * sum_c sign_cd * (prod of the
// other two axes' p) * (T[row_c] . ct_l) over the levels in registers.
//
// Atomics make the summation order change from run to run, so the gradient
// agrees with the plain version's index_add_ to float32 rounding of the sums
// (the tests allow 1e-5 x max|plain| per level), not to the bit. The position
// gradient is summed in a fixed order per thread.
//
// What bounds it on an H100: the atomics. The compulsory bytes are x (12 B)
// and ct (L*F*4 = 128 B) per sample plus the gradient table written once (50.4
// MB at the bench shape): 0.026 ms for 262,144 samples at 3.35 TB/s. It issues
// L * 8 * F = 256 float32 atomics per sample (67 M at N = 262,144); on the
// hashed levels each lands in its own 32-byte sector (11 x 8 x 2 x 32 B = 5.6
// KB per sample, 0.44 ms at the HBM rate if none of it stayed in L2). The
// coarse dense levels concentrate many samples' atomics on few rows, where
// they serialise in L2. A warp-level pre-reduction of equal rows, or a
// shared-memory table for the coarse levels, are the next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "hashgrid_common.cuh"

namespace insr {

template <int F>
__global__ void __launch_bounds__(kHashBlock)
    hashgrid_bwd_kernel(const float* __restrict__ x, long long n,
                        const float* __restrict__ ct, const float* __restrict__ table,
                        long long total, int n_levels, HashLevels levels,
                        const float* __restrict__ mask, float* __restrict__ dtable,
                        float* __restrict__ dx) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float x0 = x[3 * i], x1 = x[3 * i + 1], x2 = x[3 * i + 2];
    const float* crow = ct + i * n_levels * F;
    float dxa[3] = {0.0f, 0.0f, 0.0f};
    for (int l = 0; l < n_levels; ++l) {
      const HashLevel& lv = levels.l[l];
      const Taps t = level_taps(lv, x0, x1, x2);
      const float m = mask != nullptr ? mask[l] : 1.0f;
      float g[F];
#pragma unroll
      for (int f = 0; f < F; ++f) g[f] = mask != nullptr ? crow[l * F + f] * m : crow[l * F + f];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int f = 0; f < F; ++f) atomicAdd(dtable + f * total + t.row[c], t.w[c] * g[f]);
      }
      if (dx != nullptr) {
        float lvl[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float tg = 0.0f;
#pragma unroll
          for (int f = 0; f < F; ++f) tg = tg + __ldg(table + f * total + t.row[c]) * g[f];
          float p[3];
#pragma unroll
          for (int d = 0; d < 3; ++d) p[d] = ((c >> d) & 1) ? t.frac[d] : 1.0f - t.frac[d];
          const float excl[3] = {p[1] * p[2], p[0] * p[2], p[0] * p[1]};
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float v = excl[d] * tg;
            lvl[d] = ((c >> d) & 1) ? lvl[d] + v : lvl[d] - v;
          }
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) dxa[d] = dxa[d] + lvl[d] * lv.scale;
      }
    }
    if (dx != nullptr) {
#pragma unroll
      for (int d = 0; d < 3; ++d) dx[3 * i + d] = dxa[d];
    }
  }
}

template <int F>
int launch_hashgrid_bwd(const float* x, long long n, const float* ct, const float* table,
                        long long total, int n_levels, const HashLevels& levels,
                        const float* mask, float* dtable, float* dx, cudaStream_t stream) {
  if (n > 0) {
    hashgrid_bwd_kernel<F><<<hash_grid_for(n), kHashBlock, 0, stream>>>(
        x, n, ct, table, total, n_levels, levels, mask, dtable, dx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches (F not in {1, 2, 4, 8}, or too many levels). dtable (F, total) must
// be zeroed by the caller: the kernel adds into it. dx is nullptr (no position
// gradient) or (n, 3) float32, overwritten.
extern "C" int hashgrid_bwd(const float* x, long long n, const float* ct, const float* table,
                            long long total, int n_levels, int f,
                            const insr::HashLevel* levels, const float* mask, float* dtable,
                            float* dx, void* stream) {
  if (n_levels < 1 || n_levels > insr::kHashMaxLevels) return -1;
  insr::HashLevels lv{};
  for (int l = 0; l < n_levels; ++l) lv.l[l] = levels[l];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_HG_BWD(F_) \
  return insr::launch_hashgrid_bwd<F_>(x, n, ct, table, total, n_levels, lv, mask, dtable, dx, st)
  switch (f) {
    case 1: INSR_HG_BWD(1);
    case 2: INSR_HG_BWD(2);
    case 4: INSR_HG_BWD(4);
    case 8: INSR_HG_BWD(8);
    default: return -1;
  }
#undef INSR_HG_BWD
}
