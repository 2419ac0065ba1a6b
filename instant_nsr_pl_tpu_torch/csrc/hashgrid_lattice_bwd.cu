// HG6: the hash-grid encoding's table gradient on its tap-dedup levels (and
// their position gradient on request), and HG8: the same for the encoding
// with its position Jacobian, from the cotangents of both outputs.
//
// Replaces: instant_nsr_pl_tpu/ops/hashgrid.py _level_lattice_bwd (:333-367)
// and _level_lattice_jac_bwd (:391-455), which _encode_fast_bwd (:652-765)
// and _encode_jac_bwd (:841-957) run on the levels with
// spec.dedup_group_sizes[l] = g > 0 (XLA, not Pallas): per aligned block of
// g samples, the 27 lattice points' updates are summed over the block's
// samples and fed to the level's segment sum as 27 rows a block instead of
// 8g per-sample corners (hashgrid_lattice_fwd.cu has the lattice's premise).
//
// Design (a simple right one): one thread per (block, dedup level), as HG5.
// The thread reads its block's positions and the level's slices of the
// cotangents (times the level mask), then walks the 27 lattice points in
// order, skipping those outside the block's axis masks (hashgrid_common.cuh
// lattice_masks: their terms are exact zeros), and sums each point's update
// over the g samples in order:
//   HG6: u_j = sum_s w27_sj ct_s;
//   HG8: u_j = sum_s w27_sj ctf_s + s_l sum_s wd0_sj ctj0_s
//              + s_l sum_s wd1_sj ctj1_s + s_l sum_s wd2_sj ctj2_s
// (the JAX package's order of terms; each product and sum rounded once,
// --fmad=false), and adds a non-zero u_j to the point's row with one atomic:
// 27 row updates a block, not 8g. Rows below `wide_rows` (the dedup levels
// that are dense: coarse rows that take thousands of updates a step) go
// into a zeroed float64 scratch with float64 atomics, which a last launch
// adds, rounded once, into the float32 gradient, as HG2 does for its dense
// levels; the hashed dedup levels' rows take float32 vector atomics. A zero
// update adds nothing (exact: the gradient never holds -0).
// With d x requested the thread reads the 27 rows again (L1 hits) and sums
// per sample
//   HG6: s_l * sum_j (T[row_j] . ct) wd_dj,
//   HG8: s_l * sum_j (T[row_j] . ctf) wd_dj
//        + s_l^2 * sum_{e != d} sum_j (T[row_j] . ctj_e) dtent_e dtent_d tent_third
// in the plain version's order (ops/hashgrid.py level_lattice_bwd /
// level_lattice_jac_bwd) into an (n_lat, N, 3) scratch, and a second launch
// adds the levels' terms in level order to d x, after those of HG2 / HG4
// (which run first, on the same stream): the JAX package's order of the
// levels, and the same bits from run to run.
//
// What bounds it on an H100: the compulsory bytes are x (12 B a sample), the
// dedup levels' cotangent slices (F * 4 B a sample and level; HG8 four times
// that) and the gradient rows; the row updates are 27 a block instead of 8 a
// sample. Merging the lattices that neighbouring blocks of a ray share, and
// staging a warp's lattices in shared memory, are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "hashgrid_common.cuh"

namespace insr {

template <int F, int G, bool kJac>
__global__ void __launch_bounds__(kHashBlock)
    hashgrid_lattice_bwd_kernel(const float* __restrict__ x, long long n,
                                const float* __restrict__ ct_f, const float* __restrict__ ct_j,
                                const float* __restrict__ table, int n_levels, HashLevels levels,
                                const float* __restrict__ mask, SplitRows sink,
                                float* __restrict__ dx_part) {
  const int l = blockIdx.y;
  const HashLevel& lv = levels.l[l];
  const int g = lv.g;
  const long long i0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * g;
  if (i0 >= n) return;
  const float sc = lv.scale;
  float t[G][3];
  int a[3];
  lattice_block<G>(x, i0, g, sc, t, a);
  int am[3];
  lattice_masks<G>(t, g, am);
  // the level's cotangent slices, times the mask (zeros past g)
  const long long row = static_cast<long long>(n_levels) * F;
  const float m = mask != nullptr ? mask[l] : 1.0f;
  float cf[G][F], cj[kJac ? G : 1][3][F];
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const long long at = (i0 + s) * row + l * F;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float v = s < g ? ct_f[at + f] : 0.0f;
      cf[s][f] = mask != nullptr ? v * m : v;
      if constexpr (kJac) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          const float u = s < g ? ct_j[d * n * row + at + f] : 0.0f;
          cj[s][d][f] = mask != nullptr ? u * m : u;
        }
      }
    }
  }
  // the table gradient: one update per lattice point
  // the lattice points in order, x fastest, those outside the block's axis
  // masks skipped; only the x axis unrolled, which keeps the code within the
  // instruction cache
#pragma unroll 1
  for (int o12 = 0; o12 < 9; ++o12) {
    const int o1 = o12 % 3, o2 = o12 / 3;
    if (!((am[1] >> o1) & (am[2] >> o2) & 1)) continue;  // lattice_masks
#pragma unroll
    for (int o0 = 0; o0 < 3; ++o0) {
      if (!((am[0] >> o0) & 1)) continue;
      float u[F], ud[kJac ? 3 : 1][F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        u[f] = 0.0f;
        if constexpr (kJac) {
#pragma unroll
          for (int d = 0; d < 3; ++d) ud[d][f] = 0.0f;
        }
      }
#pragma unroll
      for (int s = 0; s < G; ++s) {
        if (s >= g) continue;
        const LatticeWeights w = lattice_weights<kJac>(t[s], o0, o1, o2);
#pragma unroll
        for (int f = 0; f < F; ++f) {
          u[f] = u[f] + w.w27 * cf[s][f];
          if constexpr (kJac) {
#pragma unroll
            for (int d = 0; d < 3; ++d) ud[d][f] = ud[d][f] + w.wd[d] * cj[s][d][f];
          }
        }
      }
      if constexpr (kJac) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
#pragma unroll
          for (int f = 0; f < F; ++f) u[f] = u[f] + sc * ud[d][f];
        }
      }
      if (nonzero(u)) add_row<F>(sink, lattice_row(lv, a, o0, o1, o2), u);
    }
  }
  if (dx_part == nullptr) return;
  // d x: per sample, each lattice point's (row . cotangent) through the tent
  // product's derivatives
  float first[G][3], second[kJac ? G : 1][3][2];
#pragma unroll
  for (int s = 0; s < G; ++s) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      first[s][d] = 0.0f;
      if constexpr (kJac) second[s][d][0] = second[s][d][1] = 0.0f;
    }
  }
  // the lattice points in order, x fastest, those outside the block's axis
  // masks skipped; only the x axis unrolled, which keeps the code within the
  // instruction cache
#pragma unroll 1
  for (int o12 = 0; o12 < 9; ++o12) {
    const int o1 = o12 % 3, o2 = o12 / 3;
    if (!((am[1] >> o1) & (am[2] >> o2) & 1)) continue;  // lattice_masks
#pragma unroll
    for (int o0 = 0; o0 < 3; ++o0) {
      if (!((am[0] >> o0) & 1)) continue;
      float v[F];
      load_row<F>(table, lattice_row(lv, a, o0, o1, o2), v);
#pragma unroll
      for (int s = 0; s < G; ++s) {
        if (s >= g) continue;
        const LatticeWeights w = lattice_weights<true>(t[s], o0, o1, o2);
        float tf = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) tf = tf + v[f] * cf[s][f];
#pragma unroll
        for (int d = 0; d < 3; ++d) first[s][d] = first[s][d] + tf * w.wd[d];
        if constexpr (kJac) {
          float tj[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int e = 0; e < 3; ++e) {
#pragma unroll
            for (int f = 0; f < F; ++f) tj[e] = tj[e] + v[f] * cj[s][e][f];
          }
          // (dtent_e dtent_d) tent_third for e != d, e in order: the pair k
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            int k = 0;
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              if (e == d) continue;
              const float d2 = (w.dw[e] * w.dw[d]) * w.w[3 - d - e];
              second[s][d][k] = second[s][d][k] + d2 * tj[e];
              ++k;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < G; ++s) {
    if (s >= g) continue;
    float* dst = dx_part + (static_cast<long long>(l) * n + i0 + s) * 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if constexpr (kJac) {
        float acc = 0.0f;
        acc = acc + second[s][d][0];
        acc = acc + second[s][d][1];
        dst[d] = sc * first[s][d] + (sc * sc) * acc;
      } else {
        dst[d] = first[s][d] * sc;
      }
    }
  }
}

// d x += the dedup levels' terms in level order (or d x = them, where no
// per-sample level wrote it first).
__global__ void lattice_dx_sum_kernel(const float* __restrict__ dx_part, long long n, int n_lat,
                                      int accumulate, float* __restrict__ dx) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= 3 * n) return;
  float acc = accumulate ? dx[j] : 0.0f;
  for (int l = 0; l < n_lat; ++l) acc = acc + dx_part[l * 3 * n + j];
  dx[j] = acc;
}

// The float64 scratch of the dense dedup levels' rows added, rounded once,
// into the gradient (whose rows there hold zeros: no other kernel adds to a
// dedup level's rows).
__global__ void __launch_bounds__(256)
    lattice_narrow_kernel(const double* __restrict__ wide, long long m, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < m;
       i += stride)
    out[i] = out[i] + static_cast<float>(wide[i]);
}

inline int lattice_min_g(const HashLevels& levels, int n_lat) {
  int g = levels.l[0].g;
  for (int l = 1; l < n_lat; ++l) g = levels.l[l].g < g ? levels.l[l].g : g;
  return g;
}

// As hashgrid_lattice_fwd.cu's: the register block size G, or 0.
inline int lattice_check(const HashLevels& levels, int n_levels, long long n, int f, int* n_lat) {
  *n_lat = lattice_levels(levels, n_levels);
  int gmax = 0;
  for (int l = 0; l < *n_lat; ++l) {
    if (n % levels.l[l].g) return 0;
    gmax = levels.l[l].g > gmax ? levels.l[l].g : gmax;
  }
  if (*n_lat == 0) return 0;
  if (gmax <= 8) return 8;
  return gmax <= 16 && f <= 2 ? 16 : 0;
}

template <int F, int G, bool kJac>
int launch_lattice_bwd(const float* x, long long n, const float* ct_f, const float* ct_j,
                       const float* table, int n_levels, const HashLevels& levels, int n_lat,
                       const float* mask, float* dtable, double* wide, uint32_t wide_rows,
                       float* dx, float* dx_part, int dx_accumulate, cudaStream_t stream) {
  const long long blocks = n / lattice_min_g(levels, n_lat);
  const dim3 grid(static_cast<unsigned>((blocks + kHashBlock - 1) / kHashBlock), n_lat);
  hashgrid_lattice_bwd_kernel<F, G, kJac><<<grid, kHashBlock, 0, stream>>>(
      x, n, ct_f, ct_j, table, n_levels, levels, mask, SplitRows{dtable, wide, wide_rows},
      dx != nullptr ? dx_part : nullptr);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  if (dx != nullptr) {
    lattice_dx_sum_kernel<<<static_cast<unsigned>((3 * n + 255) / 256), 256, 0, stream>>>(
        dx_part, n, n_lat, dx_accumulate, dx);
  }
  if (wide_rows > 0) {
    const long long m = static_cast<long long>(wide_rows) * F;
    const long long nb = (m + 255) / 256;
    lattice_narrow_kernel<<<static_cast<unsigned>(nb < 4096 ? nb : 4096), 256, 0, stream>>>(
        wide, m, dtable);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kJac>
int lattice_bwd_entry(const float* x, long long n, const float* ct_f, const float* ct_j,
                      const float* table, int n_levels, int f, const HashLevel* levels,
                      const float* mask, float* dtable, double* wide, long long wide_rows,
                      float* dx, float* dx_part, int dx_accumulate, void* stream) {
  if (n_levels < 1 || n_levels > kHashMaxLevels) return -1;
  if (wide_rows < 0 || wide_rows > 0xfffffffeLL) return -1;
  if (dx != nullptr && dx_part == nullptr) return -1;
  HashLevels lv{};
  for (int l = 0; l < n_levels; ++l) lv.l[l] = levels[l];
  int n_lat = 0;
  const int g = lattice_check(lv, n_levels, n, f, &n_lat);
  if (g == 0) return -1;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_LAT_BWD(F_, G_)                                                                   \
  return launch_lattice_bwd<F_, G_, kJac>(x, n, ct_f, ct_j, table, n_levels, lv, n_lat, mask, \
                                          dtable, wide, static_cast<uint32_t>(wide_rows), dx,  \
                                          dx_part, dx_accumulate, st)
  switch (f * 100 + g) {
    case 108: INSR_LAT_BWD(1, 8);
    case 116: INSR_LAT_BWD(1, 16);
    case 208: INSR_LAT_BWD(2, 8);
    case 216: INSR_LAT_BWD(2, 16);
    case 408: INSR_LAT_BWD(4, 8);
    case 808: INSR_LAT_BWD(8, 8);
    default: return -1;
  }
#undef INSR_LAT_BWD
}

}  // namespace insr

// Returns cudaGetLastError() after the launches, or -1 when no instantiation
// matches (as hashgrid_lattice_fwd), or d x is asked for without its
// scratch. x is (n, 3) and ct (n, n_levels * F) float32; table the row-major
// (total, F) float32 table and dtable its (total, F) float32 gradient, which
// the kernel adds into (its dedup levels' rows zero on entry); wide a zeroed
// (wide_rows, F) float64 scratch for the table's first wide_rows rows (the
// dense dedup levels'), added into dtable by the last launch. dx is nullptr
// (no position gradient) or (n, 3) float32: with dx_accumulate the dedup
// levels' terms are added to it (HG2 wrote the other levels'), else it is
// overwritten; dx_part is then an (n_dedup_levels, n, 3) float32 scratch.
extern "C" int hashgrid_lattice_bwd(const float* x, long long n, const float* ct,
                                    const float* table, int n_levels, int f,
                                    const insr::HashLevel* levels, const float* mask,
                                    float* dtable, double* wide, long long wide_rows, float* dx,
                                    float* dx_part, int dx_accumulate, void* stream) {
  return insr::lattice_bwd_entry<false>(x, n, ct, nullptr, table, n_levels, f, levels, mask,
                                        dtable, wide, wide_rows, dx, dx_part, dx_accumulate,
                                        stream);
}

// HG8: as hashgrid_lattice_bwd for the cotangents ct_f (n, n_levels * F) and
// ct_j (3, n, n_levels * F) of the features and their Jacobian (d x after
// HG4's).
extern "C" int hashgrid_lattice_jac_bwd(const float* x, long long n, const float* ct_f,
                                        const float* ct_j, const float* table, int n_levels,
                                        int f, const insr::HashLevel* levels, const float* mask,
                                        float* dtable, double* wide, long long wide_rows,
                                        float* dx, float* dx_part, int dx_accumulate,
                                        void* stream) {
  return insr::lattice_bwd_entry<true>(x, n, ct_f, ct_j, table, n_levels, f, levels, mask,
                                       dtable, wide, wide_rows, dx, dx_part, dx_accumulate,
                                       stream);
}
