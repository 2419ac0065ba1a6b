// HG5: the hash-grid encoding's forward on its tap-dedup levels, and HG7:
// the same with the position Jacobian.
//
// Replaces: instant_nsr_pl_tpu/ops/hashgrid.py _level_lattice_feat (:323-330)
// and _level_lattice_feat_jac (:370-388), which _encode_with_taps (:584-620)
// and _encode_jac_fwd_impl (:797-835) run on the levels with
// spec.dedup_group_sizes[l] = g > 0: XLA, not Pallas. Where the renderer's
// group-compacted march guarantees that every aligned block of g samples is
// one ray's uniform-step run spanning less than one cell of the level, the
// block's 8g corner taps all lie in one 3x3x3 lattice of rows anchored at
// floor(min over the block of pos); the JAX package gathers those 27 rows
// once per block and weights them per sample by the tent products
// (hashgrid_common.cuh lattice_weights).
//
// Design (a simple right one): one thread per (block, dedup level) item; a
// CUDA block takes a tile of about 128 consecutive samples (a multiple of
// every level's g, so no block straddles two tiles) and its items, level by
// level (the dedup levels are a prefix, coarse and dense for the most part,
// so their rows are L2-resident). The thread computes its block's positions
// and anchor, then walks the 27 lattice points in order: one read-only vector
// load of the point's row, and for each of the g samples the row times the
// tent product added to the sample's features (HG7: also times each axis's
// tent-product derivative, to the Jacobian), in lattice order with each
// product and sum rounded once (--fmad=false): the plain versions' order
// (ops/hashgrid.py level_lattice_feat / level_lattice_feat_jac), which sum
// all 27 points. The kernels skip the points outside the block's axis masks
// (hashgrid_common.cuh lattice_masks: on some axis no sample of the block has
// a non-zero tent or tent derivative there; a block spans less than a cell,
// so 8 of 27 points remain on most blocks), whose terms are exact zeros: the
// features equal the plain version's to the bit. The Jacobian is then scaled
// to world units and both are multiplied by the level mask, and staged in
// shared memory: after the tile's items, each sample's dedup columns of the
// (N, L*F) features that HG1 (HG3) fills for the other levels, and of the
// (3, N, L*F) Jacobian planes, are written as one contiguous run (one
// level a thread wrote its 8-byte pieces of a sample's sector at different
// times: HG7 took 0.77 ms, against 0.21 for the whole per-sample encode).
// HG1 / HG3 run first on the same stream.
//
// What bounds it on an H100: the compulsory bytes are x (12 B a sample) and
// the dedup levels' outputs (F * 4 B a sample and level; HG7 four times
// that); the rows are 27 a block instead of 8 a sample. Making it fast
// (shared-memory staging of a warp's lattices, whole-sector stores) is later
// work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "hashgrid_common.cuh"

namespace insr {

// The largest block size the instantiation holds in registers is G (a
// level's g <= G; the loops over a block's samples are unrolled to G and
// guarded). A CUDA block takes a tile of `tile` consecutive samples (a
// multiple of every g: lattice_tile) and all its (block, dedup level) items,
// which its threads share out level by level, so a warp walks neighbouring
// blocks of one level.
template <int F, int G, bool kJac>
__global__ void __launch_bounds__(kHashBlock)
    hashgrid_lattice_fwd_kernel(const float* __restrict__ x, long long n,
                                const float* __restrict__ table, int n_levels, int n_lat,
                                int tile, HashLevels levels, const float* __restrict__ mask,
                                float* __restrict__ out, float* __restrict__ jac) {
  // the tile's dedup columns, [output][sample][n_lat * F]: written out
  // below as each sample's contiguous run of columns
  extern __shared__ float stage[];
  const int cols = n_lat * F;
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  int items = 0;
  for (int l = 0; l < n_lat; ++l) items += tile / levels.l[l].g;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    int l = 0, k = it;
    while (k >= tile / levels.l[l].g) k -= tile / levels.l[l].g, ++l;
    const HashLevel& lv = levels.l[l];
    const int g = lv.g;
    const long long i0 = base + static_cast<long long>(k) * g;
    if (i0 >= n) continue;
    float t[G][3];
    int a[3];
    lattice_block<G>(x, i0, g, lv.scale, t, a);
    int am[3];
    lattice_masks<G>(t, g, am);
    float acc[G][F], ja[kJac ? G : 1][3][F];
#pragma unroll
    for (int s = 0; s < G; ++s) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        acc[s][f] = 0.0f;
        if constexpr (kJac) {
#pragma unroll
          for (int d = 0; d < 3; ++d) ja[s][d][f] = 0.0f;
        }
      }
    }
    // the lattice points in order, x fastest, those outside the block's axis
    // masks skipped; only the x axis unrolled, which keeps the code within
    // the instruction cache
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
          const LatticeWeights w = lattice_weights<kJac>(t[s], o0, o1, o2);
#pragma unroll
          for (int f = 0; f < F; ++f) {
            acc[s][f] = acc[s][f] + v[f] * w.w27;
            if constexpr (kJac) {
#pragma unroll
              for (int d = 0; d < 3; ++d) ja[s][d][f] = ja[s][d][f] + v[f] * w.wd[d];
            }
          }
        }
      }
    }
    const float m = mask != nullptr ? mask[l] : 1.0f;
#pragma unroll
    for (int s = 0; s < G; ++s) {
      if (s >= g) continue;
      float* st = stage + (k * g + s) * cols + l * F;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        st[f] = mask != nullptr ? acc[s][f] * m : acc[s][f];
        if constexpr (kJac) {
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float v = ja[s][d][f] * lv.scale;
            st[(d + 1) * tile * cols + f] = mask != nullptr ? v * m : v;
          }
        }
      }
    }
  }
  __syncthreads();
  // each sample's dedup columns as one contiguous run (consecutive threads,
  // consecutive addresses)
  const long long row = static_cast<long long>(n_levels) * F;
  const int rows = static_cast<int>(n - base < tile ? n - base : tile);
  for (int o = 0; o < (kJac ? 4 : 1); ++o) {
    float* dst = o == 0 ? out : jac + (o - 1) * n * row;
    for (int c = threadIdx.x; c < rows * cols; c += blockDim.x) {
      dst[(base + c / cols) * row + c % cols] = stage[o * tile * cols + c];
    }
  }
}

// The tile: a multiple of the least common multiple of the dedup levels'
// block sizes, so that every block of every level starts at a multiple of
// its g from 0 and lies in one tile: 128 samples rounded down to such a
// multiple (or the multiple itself where it passes 128), fewer multiples
// where the stage would pass 64 KB. Returns 0 where even one multiple's
// stage passes the card's 227 KB; *smem gets the tile's shared bytes.
inline int lattice_tile(const HashLevels& levels, int n_lat, int f, bool jac, int* smem) {
  int lcm = 1;
  for (int l = 0; l < n_lat; ++l) {
    int a = lcm, b = levels.l[l].g;  // a = gcd(lcm, g)
    while (b != 0) {
      const int r = a % b;
      a = b;
      b = r;
    }
    lcm = lcm / a * levels.l[l].g;
  }
  const int per_sample = n_lat * f * (jac ? 4 : 1) * static_cast<int>(sizeof(float));
  int mult = 128 / lcm > 1 ? 128 / lcm : 1;
  while (mult > 1 && mult * lcm * per_sample > 64 * 1024) mult /= 2;
  const int tile = mult * lcm;
  *smem = tile * per_sample;
  return *smem > 227 * 1024 ? 0 : tile;
}

template <int F, int G, bool kJac>
int launch_lattice_fwd(const float* x, long long n, const float* table, int n_levels,
                       const HashLevels& levels, int n_lat, const float* mask, float* out,
                       float* jac, cudaStream_t stream) {
  int smem = 0;
  const int tile = lattice_tile(levels, n_lat, F, kJac, &smem);
  if (tile == 0) return -1;
  if (smem > 48 * 1024) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        hashgrid_lattice_fwd_kernel<F, G, kJac>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem));
    if (rc != 0) return rc;
  }
  const long long tiles = (n + tile - 1) / tile;
  hashgrid_lattice_fwd_kernel<F, G, kJac><<<static_cast<unsigned>(tiles), kHashBlock, smem,
                                            stream>>>(x, n, table, n_levels, n_lat, tile,
                                                      levels, mask, out, jac);
  return static_cast<int>(cudaGetLastError());
}

// The dedup levels' checks: at least one, every g >= 1 dividing n, and the
// largest g within the instantiations (8, and 16 at F <= 2); returns the
// register block size G, or 0 when no instantiation holds the spec.
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

template <bool kJac>
int lattice_fwd_entry(const float* x, long long n, const float* table, int n_levels, int f,
                      const HashLevel* levels, const float* mask, float* out, float* jac,
                      void* stream) {
  if (n_levels < 1 || n_levels > kHashMaxLevels) return -1;
  HashLevels lv{};
  for (int l = 0; l < n_levels; ++l) lv.l[l] = levels[l];
  int n_lat = 0;
  const int g = lattice_check(lv, n_levels, n, f, &n_lat);
  if (g == 0) return -1;
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_LAT_FWD(F_, G_) \
  return launch_lattice_fwd<F_, G_, kJac>(x, n, table, n_levels, lv, n_lat, mask, out, jac, st)
  switch (f * 100 + g) {
    case 108: INSR_LAT_FWD(1, 8);
    case 116: INSR_LAT_FWD(1, 16);
    case 208: INSR_LAT_FWD(2, 8);
    case 216: INSR_LAT_FWD(2, 16);
    case 408: INSR_LAT_FWD(4, 8);
    case 808: INSR_LAT_FWD(8, 8);
    default: return -1;
  }
#undef INSR_LAT_FWD
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches (F not in {1, 2, 4, 8}, too many levels, no dedup level, a block
// size that does not divide n, or one above 8 (16 at F <= 2)), or a tile of
// the block sizes' common multiple does not fit in shared memory. x is (n, 3)
// float32; table the row-major (total, F) float32 table; `levels` holds
// n_levels HashLevel records, whose leading records with g > 0 are the dedup
// levels this kernel fills; mask is nullptr or (n_levels,) float32; out is
// (n, n_levels * F) float32, its dedup levels' columns overwritten.
extern "C" int hashgrid_lattice_fwd(const float* x, long long n, const float* table,
                                    int n_levels, int f, const insr::HashLevel* levels,
                                    const float* mask, float* out, void* stream) {
  return insr::lattice_fwd_entry<false>(x, n, table, n_levels, f, levels, mask, out, nullptr,
                                        stream);
}

// HG7: as hashgrid_lattice_fwd, and jac (3, n, n_levels * F) float32, its
// dedup levels' columns overwritten with the Jacobian in world units.
extern "C" int hashgrid_lattice_jac_fwd(const float* x, long long n, const float* table,
                                        int n_levels, int f, const insr::HashLevel* levels,
                                        const float* mask, float* out, float* jac,
                                        void* stream) {
  return insr::lattice_fwd_entry<true>(x, n, table, n_levels, f, levels, mask, out, jac,
                                       stream);
}
