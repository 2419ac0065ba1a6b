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
// Design: HG2's (csrc/hashgrid_bwd.cu): the scatter hash_scatter of
// hashgrid_common.cuh, instantiated with this cotangent. One thread per
// sample recomputes its taps level by level (HG1's position code, so every
// sample lands in the cell HG3 used), forms each corner's update in registers
// and adds it into the zeroed row-major (T, F) gradient with one vector
// atomic per run of equal rows, merged within the warp and then across the
// block's warps in warp order. With dx requested the thread reads its 8 rows
// again and sums
//   dx_d = s   * sum_c sign_cd excl_cd (T[row_c] . ct_f)
//        + s^2 * sum_c sum_{e != d} sign_cd sign_ce p_c,(3-d-e) (T[row_c] . ct_j[e])
// over the levels in registers, in a fixed order.
//
// What bounds it on an H100: the compulsory bytes are x (12 B), ct_f (L*F*4
// B) and ct_j (3*L*F*4 B) per sample, the gradient written once and, with dx,
// the table read once (at configs/neus-synthetic.yaml's grid: 396 B a sample
// and 2 x 21.2 MB, 0.021 ms for 65,536 samples at 3.35 TB/s); but the updates
// land on scattered rows, each a read-modify-write of its own 32-byte sector
// in L2, L * 8 of them per sample before the merge. Float32 atomics make the
// sums' order change from run to run, so the gradient agrees with the plain
// version's index_add_ to float32 rounding of the sums, not to the bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "hashgrid_common.cuh"

namespace insr {

// HG4's cotangents: ct_f (n, L*F) of the features and ct_j (3, n, L*F) of the
// Jacobian, each times the level mask.
template <int F>
struct JacCotangent {
  const float* __restrict__ ct_f;
  const float* __restrict__ ct_j;
  long long n;
  struct Level {
    float gf[F];
    float gj[3][F];
  };

  __device__ __forceinline__ Level load(long long i, int l, int n_levels, bool active,
                                        bool masked, float m) const {
    Level v;
    const long long row = i * n_levels * F + l * F;
    const long long plane = n * n_levels * F;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float a = ct_f[row + f];
      v.gf[f] = !active ? 0.0f : masked ? a * m : a;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float b = ct_j[d * plane + row + f];
        v.gj[d][f] = !active ? 0.0f : masked ? b * m : b;
      }
    }
    return v;
  }

  // u_c = w_c ct_f + dw_c0 ct_j[0] + dw_c1 ct_j[1] + dw_c2 ct_j[2], each
  // product and sum rounded once, in this order (the plain version's)
  __device__ __forceinline__ void update(const Level& g, const Taps& t, int c, float s,
                                         float (&v)[F]) const {
    float p[3], excl[3];
    corner_tents(t, c, p, excl);
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = t.w[c] * g.gf[f];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float dw = (((c >> d) & 1) ? excl[d] : -excl[d]) * s;
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = v[f] + dw * g.gj[d][f];
    }
  }

  __device__ __forceinline__ void dx(const Level& g, const Taps& t,
                                     const float* __restrict__ table, float s,
                                     float (&dxa)[3]) const {
    float first[3] = {0.0f, 0.0f, 0.0f}, second[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float rv[F];
      load_row<F>(table, t.row[c], rv);
      float tf = 0.0f, tj[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int f = 0; f < F; ++f) {
        tf = tf + rv[f] * g.gf[f];
#pragma unroll
        for (int e = 0; e < 3; ++e) tj[e] = tj[e] + rv[f] * g.gj[e][f];
      }
      float p[3], excl[3];
      corner_tents(t, c, p, excl);
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
#pragma unroll
    for (int d = 0; d < 3; ++d) dxa[d] = dxa[d] + first[d] * s + second[d] * (s * s);
  }
};

template <int F>
__global__ void __launch_bounds__(kHashBlock)
    hashgrid_jac_bwd_kernel(const float* __restrict__ x, long long n,
                            const float* __restrict__ ct_f, const float* __restrict__ ct_j,
                            const float* __restrict__ table, int n_levels, HashLevels levels,
                            const float* __restrict__ mask, float* __restrict__ dtable,
                            float* __restrict__ dx) {
  hash_scatter<F>(x, n, JacCotangent<F>{ct_f, ct_j, n}, table, n_levels, levels, mask, dtable,
                  dx);
}

template <int F>
int launch_hashgrid_jac_bwd(const float* x, long long n, const float* ct_f, const float* ct_j,
                            const float* table, int n_levels, const HashLevels& levels,
                            const float* mask, float* dtable, float* dx, cudaStream_t stream) {
  if (n > 0) {
    hashgrid_jac_bwd_kernel<F><<<hash_grid_for(n), kHashBlock, 0, stream>>>(
        x, n, ct_f, ct_j, table, n_levels, levels, mask, dtable, dx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches (F not in {1, 2, 4, 8}, or too many levels). ct_f is (n, L*F) and
// ct_j (3, n, L*F) float32; table is the row-major (total, F) f32 table and
// dtable its (total, F) f32 gradient, zeroed by the caller (the kernel adds
// into it). dx is nullptr (no position gradient) or (n, 3) float32,
// overwritten.
extern "C" int hashgrid_jac_bwd(const float* x, long long n, const float* ct_f,
                                const float* ct_j, const float* table, int n_levels, int f,
                                const insr::HashLevel* levels, const float* mask, float* dtable,
                                float* dx, void* stream) {
  if (n_levels < 1 || n_levels > insr::kHashMaxLevels) return -1;
  insr::HashLevels lv{};
  for (int l = 0; l < n_levels; ++l) lv.l[l] = levels[l];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_HG_JAC_BWD(F_)                                                                   \
  return insr::launch_hashgrid_jac_bwd<F_>(x, n, ct_f, ct_j, table, n_levels, lv, mask, dtable, \
                                           dx, st)
  switch (f) {
    case 1: INSR_HG_JAC_BWD(1);
    case 2: INSR_HG_JAC_BWD(2);
    case 4: INSR_HG_JAC_BWD(4);
    case 8: INSR_HG_JAC_BWD(8);
    default: return -1;
  }
#undef INSR_HG_JAC_BWD
}
