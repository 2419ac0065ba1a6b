// HG3: the multiresolution hash-grid encoding with its position Jacobian.
//
// Replaces: instant_nsr_pl_tpu/ops/hashgrid.py hashgrid_encode_with_jac's
// forward (_encode_jac_fwd_impl, :797-838, weights _jac_weights :779), which
// is XLA, not Pallas: per level it builds (8, N) indices and weights, gathers
// (F, 8, N) table rows with jnp.take, sums the features and, from the same
// rows, the Jacobian einsum("cdn,fcn->dfn", dw, g), and saves the taps for its
// backward. The NeuS SDF with analytic gradients runs it on every training
// step, every rendered view and the mesh's vertex colours.
//
// Here a thread takes one sample and a group of LG consecutive levels, as HG1
// (csrc/hashgrid_fwd.cu) does: per level it hashes (or strides) the 8 corners
// with HG1's position code (hashgrid_common.cuh level_taps: pos =
// fmaf(x, s, 0.5), so a sample lands in the same cell as in HG1, HG2 and the
// plain versions), issues the 8 corners' vector loads before any sum, and
// from the same 8 rows sums
// - feat: the corners in order 0..7 as fmaf after the first product, HG1's
//   sum, so feat equals HG1's output to the bit;
// - jac[d] = sum_c dw_cd * T[row_c], dw_cd = (sign_cd * excl_cd) * s in world
//   units, in corner order with each product and sum rounded once (built with
//   --fmad=false), as the plain version (ops/hashgrid.py
//   hashgrid_jac_forward_plain) sums it;
// then multiplies both by the optional level mask. Outputs: feat (N, L*F)
// level-major, as HG1; jac (3, N, L*F) coordinate-major, the JAX layout that
// CompositeEncoding.apply_with_jac extends by its xyz identity block. Nothing
// is saved for the backward: HG4 recomputes the taps. The tap-dedup levels
// (HashLevel::g > 0, a prefix) are HG7's (csrc/hashgrid_lattice_fwd.cu), as
// HG1 leaves them to HG5.
//
// What bounds it on an H100: the compulsory bytes are x (12 B), feat (L*F*4 B)
// and jac (3*L*F*4 B) per sample plus the table once: at
// configs/neus-synthetic.yaml's grid (12 levels, F = 2, a 2,647,192-row
// table, 21.2 MB) 396 B a sample, 0.014 ms for 65,536 samples at 3.35 TB/s.
// The hashed levels' corners land on random rows, one 32-byte sector each (9
// hashed levels x 8 corners x 32 B = 2.3 KB a sample, 0.045 ms for 65,536
// samples if none hit in L2). Measured on the earlier design
// (tools/bwd_bench.py --cuts; PERF.md), its Jacobian stores took a third of
// its time
// (0.091 of 0.233 ms at 262,144): each thread stored its own 32-byte slice
// of each output as two 16-byte halves, so every store instruction touched
// 32 sectors by halves; and at 64 registers (8 blocks an SM) a step's 65,536
// samples x 3 level groups ran in 1.45 waves.
//
// Design: HG1's level-major grid (blockIdx.y a group of levels, so one
// group's slice of the table is the working set in L2), and
// - each warp stages its 32 samples' slices of the 4 outputs in shared
//   memory as it sums them (no results held in registers), then writes each
//   output with lane e on piece e % P of sample e / P: one 16-byte streaming
//   store instruction fills 16 whole sectors (a sample's slice of a group of
//   4 levels at F = 2 is one sector);
// - at most 64 registers, 8 blocks an SM: 65,536 samples x 3 level groups
//   take 1.45 waves of 1,056 block slots, 262,144 take 5.8. A cap of 40
//   registers (12 blocks, one wave at 65,536) ran 28% slower: each level's
//   8 row loads no longer fit in flight at once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "hashgrid_common.cuh"

namespace insr {

// Blocks an SM should hold at F <= 2: at most 64 registers (the head comment
// has why not 12).
constexpr int kJacFwdBlocks = 8;

// The outputs: feat (N, L*F) and the Jacobian planes (3, N, L*F), level-major
// rows of L*F floats per sample.
constexpr int kJacOutputs = 4;

template <int F, int LG>
__global__ void __launch_bounds__(kHashBlock, F <= 2 ? kJacFwdBlocks : 1)
    hashgrid_jac_fwd_kernel(const float* __restrict__ x, long long n,
                            const float* __restrict__ table, int n_levels, int g0,
                            HashLevels levels, const float* __restrict__ mask,
                            float* __restrict__ out, float* __restrict__ jac) {
  constexpr int V = LG * F;  // floats of one output's level-group slice of a sample
  // per warp and output, its 32 samples' slices, staged for the write-out
  __shared__ __align__(16) float stage[kHashBlock / 32][kJacOutputs][32][V];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kHashBlock + warp * 32;
  if (base >= n) return;  // warp-uniform
  const long long i = base + lane;
  const long long ii = i < n ? i : n - 1;  // a ragged warp's idle lanes: a valid sample
  const int l0 = (blockIdx.y + g0) * LG;
  const float x0 = x[3 * ii], x1 = x[3 * ii + 1], x2 = x[3 * ii + 2];
  float(&st)[kJacOutputs][32][V] = stage[warp];
#pragma unroll
  for (int q = 0; q < LG; ++q) {
    const HashLevel& lv = levels.l[l0 + q];
    if (lv.g > 0) {  // a dedup level: zeros here, HG7's values after
#pragma unroll
      for (int k = 0; k < kJacOutputs; ++k) {
#pragma unroll
        for (int f = 0; f < F; ++f) st[k][lane][q * F + f] = 0.0f;
      }
      continue;
    }
    const Taps t = level_taps(lv, x0, x1, x2);
    float v[8][F];  // the 8 corners' rows, all loads in flight before the sums
#pragma unroll
    for (int c = 0; c < 8; ++c) load_row<F>(table, t.row[c], v[c]);
    float acc[F], ja[3][F];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float p[3], excl[3];
      corner_tents(t, c, p, excl);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float dw = (((c >> d) & 1) ? excl[d] : -excl[d]) * lv.scale;
#pragma unroll
        for (int f = 0; f < F; ++f) ja[d][f] = c == 0 ? dw * v[c][f] : ja[d][f] + dw * v[c][f];
      }
#pragma unroll
      for (int f = 0; f < F; ++f) {
        acc[f] = c == 0 ? v[c][f] * t.w[c] : fmaf(v[c][f], t.w[c], acc[f]);
      }
    }
    const float m = mask != nullptr ? mask[l0 + q] : 1.0f;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      st[0][lane][q * F + f] = mask != nullptr ? acc[f] * m : acc[f];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        st[1 + d][lane][q * F + f] = mask != nullptr ? ja[d][f] * m : ja[d][f];
      }
    }
  }
  __syncwarp();
  // the write-out: each output's 32 slices as pieces of W floats, lane e on
  // piece e % P of sample e / P, so one store instruction fills whole
  // 32-byte sectors where a slice is one (V = 8); streaming stores
  constexpr int W = V % 4 == 0 ? 4 : V % 2 == 0 ? 2 : 1;
  constexpr int P = V / W;
  const long long row = static_cast<long long>(n_levels) * F;
#pragma unroll
  for (int k = 0; k < kJacOutputs; ++k) {
    float* dst = (k == 0 ? out : jac + (k - 1) * n * row) + l0 * F;
#pragma unroll
    for (int e = lane; e < 32 * P; e += 32) {
      const int smp = e / P, pc = e % P;
      if (base + smp >= n) continue;
      float* d = dst + (base + smp) * row + pc * W;
      const float* src = &st[k][smp][pc * W];
      if constexpr (W == 4) {
        __stcs(reinterpret_cast<float4*>(d), *reinterpret_cast<const float4*>(src));
      } else if constexpr (W == 2) {
        __stcs(reinterpret_cast<float2*>(d), *reinterpret_cast<const float2*>(src));
      } else {
        __stcs(d, *src);
      }
    }
  }
}

template <int F, int LG>
int launch_hashgrid_jac_fwd(const float* x, long long n, const float* table, int n_levels,
                            const HashLevels& levels, const float* mask, float* out, float* jac,
                            cudaStream_t stream) {
  const int g0 = lattice_levels(levels, n_levels) / LG;  // the first group with a HG3 level
  if (n > 0 && g0 < n_levels / LG) {
    const dim3 grid(static_cast<unsigned>((n + kHashBlock - 1) / kHashBlock), n_levels / LG - g0);
    hashgrid_jac_fwd_kernel<F, LG><<<grid, kHashBlock, 0, stream>>>(x, n, table, n_levels, g0,
                                                                   levels, mask, out, jac);
  }
  return static_cast<int>(cudaGetLastError());
}

// Levels per thread: 4 where the level count allows it, else 2 or 1, and at
// most 8 / F, so that a sample's slice of one output is at most one 32-byte
// sector (8 floats).
template <int F>
int launch_hashgrid_jac_fwd_any(const float* x, long long n, const float* table, int n_levels,
                                const HashLevels& levels, const float* mask, float* out,
                                float* jac, cudaStream_t stream) {
  int group = n_levels % 4 == 0 ? 4 : n_levels % 2 == 0 ? 2 : 1;
  while (group * F > 8) group /= 2;
  if constexpr (F <= 2) {
    if (group == 4) {
      return launch_hashgrid_jac_fwd<F, 4>(x, n, table, n_levels, levels, mask, out, jac, stream);
    }
  }
  if constexpr (F <= 4) {
    if (group == 2) {
      return launch_hashgrid_jac_fwd<F, 2>(x, n, table, n_levels, levels, mask, out, jac, stream);
    }
  }
  return launch_hashgrid_jac_fwd<F, 1>(x, n, table, n_levels, levels, mask, out, jac, stream);
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches (F not in {1, 2, 4, 8}, or too many levels). table is the row-major
// (total, F) float32 table; `levels` holds n_levels HashLevel records; mask is
// nullptr or (n_levels,) float32; out is (n, n_levels * F) and jac (3, n,
// n_levels * F), float32.
extern "C" int hashgrid_jac_fwd(const float* x, long long n, const float* table, int n_levels,
                                int f, const insr::HashLevel* levels, const float* mask,
                                float* out, float* jac, void* stream) {
  if (n_levels < 1 || n_levels > insr::kHashMaxLevels) return -1;
  insr::HashLevels lv{};
  for (int l = 0; l < n_levels; ++l) lv.l[l] = levels[l];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_HG_JAC_FWD(F_) \
  return insr::launch_hashgrid_jac_fwd_any<F_>(x, n, table, n_levels, lv, mask, out, jac, st)
  switch (f) {
    case 1: INSR_HG_JAC_FWD(1);
    case 2: INSR_HG_JAC_FWD(2);
    case 4: INSR_HG_JAC_FWD(4);
    case 8: INSR_HG_JAC_FWD(8);
    default: return -1;
  }
#undef INSR_HG_JAC_FWD
}
