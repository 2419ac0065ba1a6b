// HG4: the table gradient of the hash encoding with its position Jacobian,
// from the cotangents of both outputs, and its position gradient on request.
//
// Replaces: instant_nsr_pl_tpu/ops/hashgrid.py _encode_jac_bwd (:841-957),
// XLA, not Pallas: from the forward's saved taps it forms per level the 8*N
// updates u_c = w_c ct_f + sum_d dw_cd ct_j[d] and sums them into the table
// gradient with a two-sort segment sum (levels of >= 2^17 rows) or bf16
// one-hot matmuls with f32 sums (smaller levels); d x is the feature
// cotangent through dw plus the Jacobian cotangent through the trilinear
// mixed second derivatives (:892-906). The NeuS SDF with analytic gradients
// runs it on every training step (its eikonal loss differentiates the
// Jacobian).
//
// What bounds it on an H100: the compulsory bytes are x (12 B), ct_f (L*F*4
// B) and ct_j (3*L*F*4 B) per sample, the gradient written once and, with dx,
// the table read once (at configs/neus-synthetic.yaml's grid: 396 B a sample
// and 2 x 21.2 MB, 0.021 ms for 65,536 samples at 3.35 TB/s); but the updates
// land on scattered rows, each a read-modify-write of its own 32-byte sector
// in L2, L * 8 of them per sample before any merge. Measured on the earlier
// design, HG2's sample-major walk (tools/bwd_bench.py --cuts; PERF.md), the
// atomics take 0.33
// of its 0.51 ms at 262,144 uniform samples and half its time at a step's
// 65,536; a level-major grid (all resident blocks on one level's slice) ran
// slower, its atomics piling onto the dense levels' rows.
//
// Design: tiles of kHashBlock samples x kTileLevels levels (one), ordered
// sample block first, so a sample block's 12 levels run at once on 12
// blocks and the card works on every level at once, as the sample-major
// walk did; one wave of blocks (as many as the card holds) walks the tiles.
// (Tiles of 4 levels, whose cotangent slices share a 32-byte sector, ran 3-
// 10% slower; every level in one tile, the sample-major schedule, 36%
// slower at 262,144: tools/bwd_bench.py --cuts.) A thread recomputes its
// sample's taps (HG1's position code, so every sample lands in the cell HG3
// used), reads the level's cotangent slices as vector loads and forms the 8
// updates in registers; each corner's runs of equal rows are summed within
// the warp and across the block's warps in warp order (scan_runs,
// merge_edges of hashgrid_common.cuh, as HG2). Fewer sector updates than
// one per corner, and less work:
// - the x-neighbour corners c and c + 1 land on rows 2k and 2k + 1 of a
//   dense level where the cell's x is even, and of a hashed level too (the
//   hash's x term has factor 1, so x and x + 1 differ in bit 0): their
//   updates go as one 16-byte atomic into one sector (scatter_pair), about
//   a quarter fewer updates on uniform samples;
// - a run whose sum is zero adds nothing, and a warp whose cotangents are
//   all zero skips the level's scans (a step's empty slots carry zero
//   cotangents, a band mask's levels zero updates; exact, since the
//   gradient never holds -0).
// With dx requested the thread reads its 8 rows again and writes the
// level's term
//   s   * sum_c sign_cd excl_cd (T[row_c] . ct_f)
// + s^2 * sum_c sum_{e != d} sign_cd sign_ce p_c,(3-d-e) (T[row_c] . ct_j[e])
// to an (L, N, 3) scratch, and a second pass sums the terms in level order:
// dx does not depend on the schedule, the same bits from run to run.
// Float32 atomics make the table gradient's order change from run to run, so
// it agrees with the plain version's index_add_ to float32 rounding of the
// sums, not to the bit. The tap-dedup levels (HashLevel::g > 0, a prefix)
// are HG8's (csrc/hashgrid_lattice_bwd.cu), which runs after this kernel and
// adds its rows and d x terms.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "hashgrid_common.cuh"

namespace insr {

// Levels a tile walks (the schedule: the head comment).
constexpr int kTileLevels = 1;

// u_c = w_c ct_f + dw_c0 ct_j[0] + dw_c1 ct_j[1] + dw_c2 ct_j[2], each product
// and sum rounded once, in this order (the plain version's)
template <int F>
__device__ __forceinline__ void jac_update(const Taps& t, int c, float s, const float (&gf)[F],
                                           const float (&gj)[3][F], float (&v)[F]) {
  float p[3], excl[3];
  corner_tents(t, c, p, excl);
#pragma unroll
  for (int f = 0; f < F; ++f) v[f] = t.w[c] * gf[f];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float dw = (((c >> d) & 1) ? excl[d] : -excl[d]) * s;
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = v[f] + dw * gj[d][f];
  }
}

// Rows 2k and 2k + 1 of the (T, F) gradient (F <= 2): one vector atomic of
// 2F floats, lo to row 2k.
template <int F>
__device__ __forceinline__ void add_pair(float* __restrict__ dtable, uint32_t row,
                                         const float (&lo)[F], const float (&hi)[F]) {
  float* p = dtable + static_cast<long long>(row) * F;
  if constexpr (F == 1) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(lo[0], hi[0]));
  } else {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(lo[0], lo[1], hi[0], hi[1]));
  }
}

// The x-neighbour corners c (x bit clear) and c + 1 of one level, each
// scanned over its runs of equal rows (scan_runs); a run whose sum is zero
// in every feature adds nothing (merge_edges has why that is exact). A lane
// that ends a run of both corners on rows 2k and 2k + 1 adds them with one
// vector atomic on one sector instead of two: a dense level's x-neighbours
// are adjacent rows, and a hashed level's too where the cell's x is even (the
// hash's x term has factor 1, so x and x + 1 differ in bit 0 only).
template <int F>
__device__ __forceinline__ void scatter_pair(int c, uint32_t row0, float (&v0)[F], uint32_t row1,
                                             float (&v1)[F], bool active, EdgeRuns<F>& edges,
                                             float* __restrict__ dtable) {
  const bool add0 = scan_runs<F>(c, row0, v0, edges) && active && nonzero(v0);
  const bool add1 = scan_runs<F>(c + 1, row1, v1, edges) && active && nonzero(v1);
  if constexpr (F <= 2) {
    if (add0 && add1 && (row0 ^ row1) == 1u) {
      if (row0 < row1) {
        add_pair<F>(dtable, row0, v0, v1);
      } else {
        add_pair<F>(dtable, row1, v1, v0);
      }
      return;
    }
  }
  if (add0) add_row<F>(dtable, row0, v0);
  if (add1) add_row<F>(dtable, row1, v1);
}

template <int F>
__global__ void __launch_bounds__(kHashBlock)
    hashgrid_jac_bwd_kernel(const float* __restrict__ x, long long n,
                            const float* __restrict__ ct_f, const float* __restrict__ ct_j,
                            const float* __restrict__ table, int n_levels, int level0,
                            HashLevels levels, const float* __restrict__ mask,
                            float* __restrict__ dtable, float* __restrict__ dx_part) {
  // two buffers, so one barrier per level suffices
  __shared__ EdgeRuns<F> edges[2];
  // levels level0 .. n_levels - 1 (the dedup levels before them are HG8's)
  const int groups = (n_levels - level0 + kTileLevels - 1) / kTileLevels;
  const long long blocks = (n + kHashBlock - 1) / kHashBlock;
  const long long plane = n * n_levels * F;
  int buf = 0;
  // block-uniform loops (the barrier below): tile t is sample block t / groups
  // and level group t % groups
  for (long long t = blockIdx.x; t < blocks * groups; t += gridDim.x) {
    const long long i = t / groups * kHashBlock + threadIdx.x;
    const int l0 = level0 + static_cast<int>(t % groups) * kTileLevels;
    const bool active = i < n;
    const long long ii = active ? i : n - 1;  // a valid address for idle lanes
    const float x0 = x[3 * ii], x1 = x[3 * ii + 1], x2 = x[3 * ii + 2];
#pragma unroll 1
    for (int l = l0; l < l0 + kTileLevels && l < n_levels; ++l, buf ^= 1) {
      const HashLevel& lv = levels.l[l];
      const Taps tp = level_taps(lv, x0, x1, x2);
      // the level's slice of each cotangent (one vector load; the rest of
      // its sector serves the tile's next levels from L1), times the mask
      float gf[F], gj[3][F];
      const long long at = (ii * n_levels + l) * F;
      load_vec<F>(ct_f + at, gf);
#pragma unroll
      for (int d = 0; d < 3; ++d) load_vec<F>(ct_j + d * plane + at, gj[d]);
      const float m = mask != nullptr ? mask[l] : 1.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        gf[f] = !active ? 0.0f : mask != nullptr ? gf[f] * m : gf[f];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          gj[d][f] = !active ? 0.0f : mask != nullptr ? gj[d][f] * m : gj[d][f];
        }
      }
      // a warp whose cotangents are all zero here (a step's empty slots, a
      // masked level) adds nothing: it stages no edge runs and skips the scans
      if (__all_sync(0xffffffffu, !nonzero(gf) && !nonzero(gj[0]) && !nonzero(gj[1]) &&
                                      !nonzero(gj[2]))) {
        const int lane = threadIdx.x & 31;
        if (lane < 8) {
          edges[buf].row[lane][threadIdx.x >> 5][0] = kNoRow;
          edges[buf].row[lane][threadIdx.x >> 5][1] = kNoRow;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 8; c += 2) {
          float v0[F], v1[F];
          jac_update<F>(tp, c, lv.scale, gf, gj, v0);
          jac_update<F>(tp, c + 1, lv.scale, gf, gj, v1);
          scatter_pair<F>(c, active ? tp.row[c] : kNoRow, v0, active ? tp.row[c + 1] : kNoRow,
                          v1, active, edges[buf], dtable);
        }
      }
      __syncthreads();  // every warp's edge runs of this level are staged
      merge_edges<F, true>(edges[buf], dtable);
      if (dx_part != nullptr && active) {
        // this level's term of d x: the feature cotangent through dw, the
        // Jacobian cotangent through the mixed second derivatives
        float first[3] = {0.0f, 0.0f, 0.0f}, second[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float rv[F];
          load_row<F>(table, tp.row[c], rv);
          float tf = 0.0f, tj[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int f = 0; f < F; ++f) {
            tf = tf + rv[f] * gf[f];
#pragma unroll
            for (int e = 0; e < 3; ++e) tj[e] = tj[e] + rv[f] * gj[e][f];
          }
          float p[3], excl[3];
          corner_tents(tp, c, p, excl);
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float v = excl[d] * tf;
            first[d] = ((c >> d) & 1) ? first[d] + v : first[d] - v;
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              if (e == d) continue;
              // sign_cd * sign_ce: + where the corner sets both bits or neither
              const float w2 = p[3 - d - e] * tj[e];
              second[d] = (((c >> d) ^ (c >> e)) & 1) ? second[d] - w2 : second[d] + w2;
            }
          }
        }
        float* dst = dx_part + (static_cast<long long>(l) * n + i) * 3;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          dst[d] = first[d] * lv.scale + second[d] * (lv.scale * lv.scale);
        }
      }
    }
  }
}

// d x = the levels' terms summed in level order from 0, whatever the
// schedule that wrote them: the same bits from run to run.
__global__ void hashgrid_dx_sum_kernel(const float* __restrict__ dx_part, long long n,
                                       int first, int n_levels, float* __restrict__ dx) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= 3 * n) return;
  float acc = 0.0f;
  for (int l = first; l < n_levels; ++l) acc = acc + dx_part[l * 3 * n + j];
  dx[j] = acc;
}

// One wave: as many blocks as the card holds at once (each walks its tiles
// in steps of the grid), or fewer where there are fewer tiles.
template <int F>
int jac_bwd_grid(long long tiles) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 1, per_sm = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hashgrid_jac_bwd_kernel<F>,
                                                  kHashBlock, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  return static_cast<int>(tiles < resident ? tiles : resident);
}

template <int F>
int launch_hashgrid_jac_bwd(const float* x, long long n, const float* ct_f, const float* ct_j,
                            const float* table, int n_levels, const HashLevels& levels,
                            const float* mask, float* dtable, float* dx, float* dx_part,
                            cudaStream_t stream) {
  const int first = lattice_levels(levels, n_levels);
  if (n > 0 && first < n_levels) {
    const long long tiles = (n_levels - first + kTileLevels - 1) / kTileLevels *
                            ((n + kHashBlock - 1) / kHashBlock);
    hashgrid_jac_bwd_kernel<F><<<jac_bwd_grid<F>(tiles), kHashBlock, 0, stream>>>(
        x, n, ct_f, ct_j, table, n_levels, first, levels, mask, dtable,
        dx != nullptr ? dx_part : nullptr);
    if (dx != nullptr) {
      const int rc = static_cast<int>(cudaGetLastError());
      if (rc != 0) return rc;
      hashgrid_dx_sum_kernel<<<static_cast<unsigned>((3 * n + 255) / 256), 256, 0, stream>>>(
          dx_part, n, first, n_levels, dx);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Returns cudaGetLastError() after the launches, or -1 when no instantiation
// matches (F not in {1, 2, 4, 8}, or too many levels) or d x is asked for
// without its scratch. ct_f is (n, L*F) and ct_j (3, n, L*F) float32; table
// is the row-major (total, F) f32 table and dtable its (total, F) f32
// gradient, zeroed by the caller (the kernel adds into it). dx is nullptr (no
// position gradient) or (n, 3) float32, overwritten, and then dx_part an (L,
// n, 3) float32 scratch for the levels' terms.
extern "C" int hashgrid_jac_bwd(const float* x, long long n, const float* ct_f,
                                const float* ct_j, const float* table, int n_levels, int f,
                                const insr::HashLevel* levels, const float* mask, float* dtable,
                                float* dx, float* dx_part, void* stream) {
  if (n_levels < 1 || n_levels > insr::kHashMaxLevels) return -1;
  if (dx != nullptr && dx_part == nullptr) return -1;
  insr::HashLevels lv{};
  for (int l = 0; l < n_levels; ++l) lv.l[l] = levels[l];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_HG_JAC_BWD(F_)                                                                   \
  return insr::launch_hashgrid_jac_bwd<F_>(x, n, ct_f, ct_j, table, n_levels, lv, mask, dtable, \
                                           dx, dx_part, st)
  switch (f) {
    case 1: INSR_HG_JAC_BWD(1);
    case 2: INSR_HG_JAC_BWD(2);
    case 4: INSR_HG_JAC_BWD(4);
    case 8: INSR_HG_JAC_BWD(8);
    default: return -1;
  }
#undef INSR_HG_JAC_BWD
}
