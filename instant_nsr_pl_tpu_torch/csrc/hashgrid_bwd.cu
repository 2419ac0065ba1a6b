// HG2: the hash-grid encoding's table gradient, and its position gradient on
// request.
//
// Replaces: instant_nsr_pl_tpu/ops/hashgrid.py _encode_fast_bwd (:652-737),
// XLA, not Pallas: from the forward's saved taps it forms per level the 8*N
// updates w_c * ct and sums them into the table gradient with a two-sort
// segment sum (ops/segment.py, levels of >= 2^17 rows) or bf16 one-hot
// matmuls with f32 sums (smaller levels), because the TPU has no fast scatter;
// the position gradient is _level_dx (:635-650).
//
// What bounds it on an H100: the scatter. The compulsory bytes are x (12 B)
// and ct (L*F*4 = 128 B) per sample plus the gradient table written once (50.4
// MB at the bench shape): 0.026 ms for 262,144 samples at 3.35 TB/s. But the
// updates land on scattered rows: L * 8 corners per sample (33.6 M at N =
// 262,144), each a read-modify-write of its own 32-byte sector in L2, dense
// coarse levels and hashed fine ones alike. Measured on the thread-per-sample
// design (tools/bwd_bench.py --cuts), scattered f32 atomics ran at about 50 G
// sector updates per second on either kind of level, about four times slower
// than row-coalesced 16-byte atomics.
//
// Design: one thread per sample, a warp on 32 consecutive samples, walks the
// levels and recomputes its 8 taps (HG4, csrc/hashgrid_jac_bwd.cu, shares its
// merges of equal rows, hashgrid_common.cuh). Three changes against
// one f32 atomicAdd per corner and feature into a feature-major (F, T) table:
// - the gradient is row-major (T, F) f32, the layout of the port's table, so
//   a corner's F features are one 8-byte (F = 2) or 16-byte vector atomic on
//   one sector, not F atomics on F sectors;
// - a merge of equal rows within the warp, per level and corner: where any
//   lane's row equals its left neighbour's (a ray's neighbouring samples on a
//   coarse level), a segmented scan over the warp's runs of equal rows (five
//   shuffle steps) sums each run's values in a fixed order, and the run's
//   last lane adds the sum with one atomic. On a ray equal rows are
//   neighbours: its cell index moves monotonically along each axis. On
//   uniformly scattered samples the test finds no run and costs one shuffle
//   and one vote per corner. (Grouping by __match_any_sync, which also finds
//   equal rows that are not neighbours, with a lane-order sum took 0.56 ms on
//   ray-ordered samples against 0.60 without a merge; the run scan takes
//   0.41: tools/bwd_bench.py --cuts.)
// - a merge across the block's warps, in warp order: each warp's first and
//   last run of a level go to shared memory instead of to L2, and after the
//   level one thread per corner walks the block's warps in order, adds the
//   runs that hold the same row (a run that straddles a warp boundary, or a
//   whole block on one row) and sends one atomic per merged run. A run of
//   equal rows, however many warps it spans, then takes one float32 atomic
//   per block and level, summed within the block in a fixed order (4,096
//   samples on one point: 32 atomics a row, not 128).
// A shared-memory table for the dense levels was not built: by the same
// measurement the contended coarse levels (4 MB, L2-resident) cost per update
// what the hashed levels (50 MB, beyond L2) cost, so the number of sector
// updates sets the time, and level 0 holds 1/16 of them.
//
// Atomics make the summation order across blocks change from run to run. On
// the dense (coarse) levels a row takes thousands of updates (9,326 on the
// busiest level-2 row of 65,536 contracted points at nerf-colmap.yaml's
// grid), and a float32 running sum in a random order strayed from the
// float64 sum by more than 1e-5 x max|sum| of the level in 1 of 100 runs on
// an H100 (tools/repeat_pytest.py). So the rows of the dense levels (the first rows
// of the table, below `wide_rows`) add their run sums with float64 atomics
// into a zeroed float64 scratch, which a second launch rounds into the
// float32 gradient once: there the order no longer shows beyond the float32
// partial sums of a warp's or block's runs. The hashed levels, whose rows
// take a few updates each, keep the float32 vector atomics.
// With dx requested the thread also reads its 8 rows again and sums dL/dx_d =
// s * sum_c sign_cd * (prod of the other two axes' p) * (T[row_c] . ct_l) over
// the levels in registers, in a fixed order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "hashgrid_common.cuh"

namespace insr {

// One thread per sample, a warp on 32 consecutive samples, walks the levels,
// recomputes its 8 taps and adds each corner's update w_c * ct_l (times the
// level mask), merged within the warp and across the block's warps
// (scatter_corner, merge_edges), into the zeroed row-major (T, F) gradient.
// With dx requested each thread also adds its levels' position gradient
// s * sum_c sign_cd * excl_cd * (T[row_c] . ct_l) in registers, in a fixed
// order.
template <int F>
__global__ void __launch_bounds__(kHashBlock)
    hashgrid_bwd_kernel(const float* __restrict__ x, long long n,
                        const float* __restrict__ ct, const float* __restrict__ table,
                        int n_levels, int first, HashLevels levels,
                        const float* __restrict__ mask, SplitRows dtable,
                        float* __restrict__ dx) {
  // two buffers, so one barrier per level suffices
  __shared__ EdgeRuns<F> edges[2];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  int buf = 0;
  // block-uniform loop (the barriers below); each warp on 32 consecutive samples
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    const bool active = i < n;
    const long long ii = active ? i : n - 1;  // a valid address for idle lanes
    const float x0 = x[3 * ii], x1 = x[3 * ii + 1], x2 = x[3 * ii + 2];
    const float* crow = ct + ii * n_levels * F;
    float dxa[3] = {0.0f, 0.0f, 0.0f};
    for (int l = first; l < n_levels; ++l, buf ^= 1) {  // the dedup levels are HG6's
      const HashLevel& lv = levels.l[l];
      const Taps t = level_taps(lv, x0, x1, x2);
      const float m = mask != nullptr ? mask[l] : 1.0f;
      float g[F];  // the level's cotangent (zeros for an idle lane)
#pragma unroll
      for (int f = 0; f < F; ++f) {
        g[f] = !active ? 0.0f : mask != nullptr ? crow[l * F + f] * m : crow[l * F + f];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = t.w[c] * g[f];
        scatter_corner<F>(c, active ? t.row[c] : kNoRow, v, active, edges[buf], dtable);
      }
      __syncthreads();  // every warp's edge runs of this level are staged
      merge_edges<F, false>(edges[buf], dtable);
      if (dx != nullptr) {
        float lvl[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float rv[F];
          load_row<F>(table, t.row[c], rv);
          float tg = 0.0f;
#pragma unroll
          for (int f = 0; f < F; ++f) tg = tg + rv[f] * g[f];
          float p[3], excl[3];
          corner_tents(t, c, p, excl);
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
    if (dx != nullptr && active) {
#pragma unroll
      for (int d = 0; d < 3; ++d) dx[3 * i + d] = dxa[d];
    }
  }
}

// The float64 scratch of the dense levels' rows rounded into the gradient.
__global__ void __launch_bounds__(256)
    narrow_rows_kernel(const double* __restrict__ wide, long long n, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = static_cast<float>(wide[i]);
}

// Grid of a grid-stride launch: enough blocks to fill every SM a few times.
inline int hash_grid_for(long long n) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (n + kHashBlock - 1) / kHashBlock;
  const long long cap = 16LL * sms;
  return static_cast<int>(need < cap ? (need > 0 ? need : 1) : cap);
}

template <int F>
int launch_hashgrid_bwd(const float* x, long long n, const float* ct, const float* table,
                        int n_levels, const HashLevels& levels, const float* mask, float* dtable,
                        double* wide, uint32_t wide_rows, float* dx, cudaStream_t stream) {
  const int first = lattice_levels(levels, n_levels);
  if (n > 0 && first < n_levels) {
    hashgrid_bwd_kernel<F><<<hash_grid_for(n), kHashBlock, 0, stream>>>(
        x, n, ct, table, n_levels, first, levels, mask, SplitRows{dtable, wide, wide_rows}, dx);
    if (wide_rows > 0) {
      const long long m = static_cast<long long>(wide_rows) * F;
      const long long blocks = (m + 255) / 256;
      narrow_rows_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
                           stream>>>(wide, m, dtable);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Returns cudaGetLastError() after the launches, or -1 when no instantiation
// matches (F not in {1, 2, 4, 8}, or too many levels). table is the row-major
// (total, F) f32 table and dtable its (total, F) f32 gradient, zeroed by the
// caller (the kernel adds into it); wide a (wide_rows, F) float64 scratch,
// zeroed by the caller, for the table's first wide_rows rows (the dense
// levels'), which the second launch writes into dtable. dx is nullptr (no
// position gradient) or (n, 3) float32, overwritten.
extern "C" int hashgrid_bwd(const float* x, long long n, const float* ct, const float* table,
                            int n_levels, int f, const insr::HashLevel* levels,
                            const float* mask, float* dtable, double* wide, long long wide_rows,
                            float* dx, void* stream) {
  if (n_levels < 1 || n_levels > insr::kHashMaxLevels) return -1;
  if (wide_rows < 0 || wide_rows > 0xfffffffeLL) return -1;
  insr::HashLevels lv{};
  for (int l = 0; l < n_levels; ++l) lv.l[l] = levels[l];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_HG_BWD(F_) \
  return insr::launch_hashgrid_bwd<F_>(x, n, ct, table, n_levels, lv, mask, dtable, wide, \
                                       static_cast<uint32_t>(wide_rows), dx, st)
  switch (f) {
    case 1: INSR_HG_BWD(1);
    case 2: INSR_HG_BWD(2);
    case 4: INSR_HG_BWD(4);
    case 8: INSR_HG_BWD(8);
    default: return -1;
  }
#undef INSR_HG_BWD
}
