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
// levels and recomputes its 8 taps (hashgrid_common.cuh). Two changes against
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
// A shared-memory table for the dense levels was not built: by the same
// measurement the contended coarse levels (4 MB, L2-resident) cost per update
// what the hashed levels (50 MB, beyond L2) cost, so the number of sector
// updates sets the time, and level 0 holds 1/16 of them.
//
// Atomics make the summation order change from run to run, so the gradient
// agrees with the plain version's index_add_ to float32 rounding of the sums
// (the tests allow 1e-5 x max|plain| per level), not to the bit. With dx
// requested the thread also reads its 8 rows again and sums dL/dx_d = s *
// sum_c sign_cd * (prod of the other two axes' p) * (T[row_c] . ct_l) over the
// levels in registers, in a fixed order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "hashgrid_common.cuh"

namespace insr {

// Add v to row `row` of the (T, F) f32 gradient: one vector atomic per 16
// bytes (Hopper, CUDA >= 12.1).
template <int F>
__device__ __forceinline__ void add_row(float* __restrict__ dtable, uint32_t row,
                                        const float (&v)[F]) {
  float* p = dtable + static_cast<long long>(row) * F;
  if constexpr (F == 1) {
    atomicAdd(p, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < F; q += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + q), make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]));
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kHashBlock)
    hashgrid_bwd_kernel(const float* __restrict__ x, long long n,
                        const float* __restrict__ ct, const float* __restrict__ table,
                        int n_levels, HashLevels levels, const float* __restrict__ mask,
                        float* __restrict__ dtable, float* __restrict__ dx) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // warp-uniform loop over each warp's 32 consecutive samples
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long i = base + lane;
    const bool active = i < n;
    const long long ii = active ? i : n - 1;  // a valid address for idle lanes
    const float x0 = x[3 * ii], x1 = x[3 * ii + 1], x2 = x[3 * ii + 2];
    const float* crow = ct + ii * n_levels * F;
    float dxa[3] = {0.0f, 0.0f, 0.0f};
    for (int l = 0; l < n_levels; ++l) {
      const HashLevel& lv = levels.l[l];
      const Taps t = level_taps(lv, x0, x1, x2);
      const float m = mask != nullptr ? mask[l] : 1.0f;
      float g[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        g[f] = !active ? 0.0f : mask != nullptr ? crow[l * F + f] * m : crow[l * F + f];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t row = active ? t.row[c] : 0xffffffffu;  // idle lanes: no table row
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = t.w[c] * g[f];
        const uint32_t left = __shfl_up_sync(kAll, row, 1);
        const bool head = lane == 0 || left != row;  // the first lane of a run of equal rows
        if (__any_sync(kAll, !head)) {
          // a segmented inclusive scan over each run of lanes: afterwards the
          // run's last lane holds the run's sum, taken in a fixed order
          const unsigned heads = __ballot_sync(kAll, head);
          const unsigned upto = lane == 31 ? kAll : (2u << lane) - 1u;
          const int start = 31 - __clz(heads & upto);
#pragma unroll
          for (int d = 1; d < 32; d *= 2) {
#pragma unroll
            for (int f = 0; f < F; ++f) {
              const float up = __shfl_up_sync(kAll, v[f], d);
              if (lane - d >= start) v[f] += up;
            }
          }
          const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
          if (active && tail) add_row<F>(dtable, row, v);
        } else if (active) {
          add_row<F>(dtable, row, v);
        }
      }
      if (dx != nullptr) {
        float lvl[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float rv[F];
          load_row<F>(table, t.row[c], rv);
          float tg = 0.0f;
#pragma unroll
          for (int f = 0; f < F; ++f) tg = tg + rv[f] * g[f];
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
    if (dx != nullptr && active) {
#pragma unroll
      for (int d = 0; d < 3; ++d) dx[3 * i + d] = dxa[d];
    }
  }
}

template <int F>
int launch_hashgrid_bwd(const float* x, long long n, const float* ct, const float* table,
                        int n_levels, const HashLevels& levels, const float* mask, float* dtable,
                        float* dx, cudaStream_t stream) {
  if (n > 0) {
    hashgrid_bwd_kernel<F><<<hash_grid_for(n), kHashBlock, 0, stream>>>(
        x, n, ct, table, n_levels, levels, mask, dtable, dx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches (F not in {1, 2, 4, 8}, or too many levels). table is the row-major
// (total, F) f32 table and dtable its (total, F) f32 gradient, zeroed by the
// caller (the kernel adds into it). dx is nullptr (no position gradient) or
// (n, 3) float32, overwritten.
extern "C" int hashgrid_bwd(const float* x, long long n, const float* ct, const float* table,
                            int n_levels, int f, const insr::HashLevel* levels,
                            const float* mask, float* dtable, float* dx, void* stream) {
  if (n_levels < 1 || n_levels > insr::kHashMaxLevels) return -1;
  insr::HashLevels lv{};
  for (int l = 0; l < n_levels; ++l) lv.l[l] = levels[l];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_HG_BWD(F_) \
  return insr::launch_hashgrid_bwd<F_>(x, n, ct, table, n_levels, lv, mask, dtable, dx, st)
  switch (f) {
    case 1: INSR_HG_BWD(1);
    case 2: INSR_HG_BWD(2);
    case 4: INSR_HG_BWD(4);
    case 8: INSR_HG_BWD(8);
    default: return -1;
  }
#undef INSR_HG_BWD
}
