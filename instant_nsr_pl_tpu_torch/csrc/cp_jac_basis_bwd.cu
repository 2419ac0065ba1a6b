// Backward of the fused CP product + Jacobian + basis projection (K10):
// (d enc (F, N), d jac (3, F, N)) -> (d lines (3, R, C), d u (3, N), d B (C, F)).
//
// Replaces: instant_nsr_pl_tpu/ops/cp_pallas.py _cp_jacb_bwd -> _jacb_bwd_kernel
// (pallas_call at :676). It reads the forward's bf16 residuals vsave and
// gdsave (3, C, N) (csrc/cp_jac_basis_fwd.cu training mode), never the tables,
// and follows the TPU kernel's rounding points. Per sample, with s_a = (R - 1)
// * d clip(u_a)/du_a, other_a = product of the other two axes' v, and (b, c)
// the other two axes of a:
//   prod = v_x * other_x,  jpre_a = (gd_a * s_a) * other_a  (recomputed, f32)
//   dP  = B bf16(d enc),  dJ_a = B bf16(d jac_a)                   (f32 sums)
//   dB += bf16(prod) bf16(d enc)^T + sum_a bf16(jpre_a) bf16(d jac_a)^T
//   gs_a   = (dJ_a * gd_a) * s_a
//   d v_a  = dP * other_a + gs_b * v_c + gs_c * v_b
//   d gd_a = (dJ_a * s_a) * other_a
//   d u_a  = (sum_C d v_a * gd_a) * s_a                   (the f32 d v)
//   dL_a[i0]     += w0 * bf16(d v_a) - bf16(d gd_a)
//   dL_a[i0 + 1] += w1 * bf16(d v_a) + bf16(d gd_a)
// The last two lines are the TPU's dense bf16(d v) x tent^T + bf16(d gd) x
// diff-hot^T matmuls restricted to their two non-zero rows.
//
// Cross-sample sums: the TPU accumulates d lines and d B^T in VMEM across its
// sequential grid; CUDA blocks run in no order. As in csrc/cp_mlp_bwd.cu, each
// block (one per SM) walks 128-sample tiles. d B is a sum over samples of four
// outer products: per tile every sample stages its four bf16 C-rows (prod,
// jpre_x, jpre_y, jpre_z) and four bf16 F-rows (d enc, d jac_x, d jac_y,
// d jac_z) in shared memory, reduce_tile (mlp_common.cuh) sums the 512 rows
// into a per-block (C, F) f32 accumulator, and the block adds it to the output
// with one atomic per element at the end. The line-table gradient is a
// data-dependent scatter: two rows per sample and axis, added with 16-byte
// vector atomics. The summation order changes from run to run, so results
// agree with the plain version to f32 rounding of the sums, not to the bit.
//
// What bounds it on an H100: HBM. Per sample it reads u (12 B), vsave and
// gdsave (768 B at C = 64), d enc and d jac (256 B at F = 16) and writes d u
// (12 B): 1,048 B, 82 us at 3.35 TB/s for 262,144 samples. It does ~12k
// multiply-adds per sample on the CUDA cores (0.1 ms at 67 TFLOP/s f32). This
// first version is latency-bound instead: one 128-thread block per SM (176 KB
// of shared memory at C = 64, F = 16; 184 KB at C = 128, bench.py --encoding
// cp_big, whose d B is reduced over two tiles of 64 components), CUDA-core
// tile reductions and 6 x C / 4
// vector atomics per sample.
//
// Stacked scales (K12): the kernel is written for S scales sharing one (3, R,
// S*C) table, with an (S, C, F) basis, cotangents d enc (S*F, N) and d jac
// (3, S*F, N), residuals (3, S*C, N), and outputs d lines (3, R, S*C), d u
// (3, N) and d B (S, C, F). K10 is its S = 1 instantiation. With S = 2 it
// replaces cp_pallas.py _cp_jacs_bwd -> _jacs_bwd_kernel (pallas_call at :952):
// one tent per axis at R_max; per tile the scales are staged and reduced one
// after the other into their own (C, F) block of d B (the diagonal blocks of
// the TPU's (E, S*C) d B^T); d u sums over all S*C components; each sample
// scatters two S*C-wide rows per axis into the one fine gradient table, which
// ops/cp_stacked.py maps back to each coarse scale (U^T d fine). At S*C = 128,
// F = 16 the function moves 2,072 B per sample (0.16 ms at 3.35 TB/s for
// 262,144 samples); shared memory is 184 KB per block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "cp_common.cuh"

namespace insr {

template <int C, int F, int S>
struct JacBwdSmem {
  // components staged per d B reduction: all of them up to 64, else tiles of
  // 64 (C = 128 would need 315 KB of stage, more than a block may have)
  static constexpr int CT = C <= 64 ? C : 64;
  static constexpr int LDA = CT + 1;  // staged bf16 component rows (odd stride)
  static constexpr int LDG = F + 1;   // staged bf16 F-rows (odd stride)
  static constexpr int ROWS = 4 * kBwdTile;
  // basis (S, C, F), d B accumulator (S, C, F), one tile's C-rows and F-rows
  static constexpr int FLOATS = 2 * S * C * F + ROWS * (LDA + LDG);
  static_assert(LDA % 2 == 1 && LDG % 2 == 1 && C % CT == 0, "odd strides, whole tiles");
};

template <int C, int F, int S>
__global__ void __launch_bounds__(kBwdTile)
    cp_jac_basis_bwd_kernel(const float* __restrict__ u3, long long n, int r,
                            const __nv_bfloat16* __restrict__ vsave,
                            const __nv_bfloat16* __restrict__ gdsave,
                            const float* __restrict__ denc, const float* __restrict__ djac,
                            const __nv_bfloat16* __restrict__ basis,
                            float* __restrict__ dlines, float* __restrict__ du,
                            float* __restrict__ dbasis) {
  using L = JacBwdSmem<C, F, S>;
  constexpr int LD = S * C;  // row stride of the tables and residual rows
  static_assert(C % 4 == 0 && F % 4 == 0 && kBwdTile % F == 0, "layout");
  extern __shared__ float4 smem4[];
  float* b_s = reinterpret_cast<float*>(smem4);  // (S, C, F)
  float* acc = b_s + S * C * F;                   // (S, C, F)
  float* a_s = acc + S * C * F;                   // (ROWS, LDA)
  float* g_s = a_s + L::ROWS * L::LDA;            // (ROWS, LDG)
  load_bf16_to_shared(basis, S * C * F, b_s);
  for (int k = threadIdx.x; k < S * C * F; k += blockDim.x) acc[k] = 0.0f;

  const long long ntiles = (n + kBwdTile - 1) / kBwdTile;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long idx = tile * kBwdTile + threadIdx.x;
    const bool active = idx < n;
    const long long i = active ? idx : n - 1;  // a valid address for idle lanes

    Tent t[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) t[a] = tent(u3[a * n + i], r);
    float acc_u[3] = {0.0f, 0.0f, 0.0f};
    // one scale (output block) at a time: components s*C .. s*C+C-1
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      __syncthreads();  // the basis is loaded; the previous reduction is done
      // this sample's bf16 cotangents of the block, staged as its four F-rows
      float de[F], dj[3][F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const long long row = s * F + f;
        de[f] = active ? bf16_round(denc[row * n + i]) : 0.0f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          dj[a][f] = active ? bf16_round(djac[(a * S * F + row) * n + i]) : 0.0f;
        }
      }
      float* grow[4];
      float* arow[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        grow[k] = g_s + (k * kBwdTile + threadIdx.x) * L::LDG;
        arow[k] = a_s + (k * kBwdTile + threadIdx.x) * L::LDA;
      }
#pragma unroll
      for (int f = 0; f < F; ++f) {
        grow[0][f] = de[f];
        grow[1][f] = dj[0][f];
        grow[2][f] = dj[1][f];
        grow[3][f] = dj[2][f];
      }

      float* drow0[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        drow0[a] = dlines + (static_cast<long long>(a) * r + t[a].i0) * LD + s * C;
      }
#pragma unroll 1
      for (int c0 = 0; c0 < C; c0 += L::CT) {
        if (c0 > 0) __syncthreads();  // the previous tile's reduction is done
#pragma unroll 1
        for (int c4 = c0 / 4; c4 < (c0 + L::CT) / 4; ++c4) {
          float dvr[3][4], dgr[3][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = 4 * c4 + q;  // component within the block
            float v[3], gd[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const long long off = (static_cast<long long>(a) * LD + s * C + c) * n + i;
              v[a] = __bfloat162float(vsave[off]);
              gd[a] = __bfloat162float(gdsave[off]);
            }
            const float other[3] = {v[1] * v[2], v[0] * v[2], v[0] * v[1]};
            const float prod = v[0] * other[0];
            float jpre[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) jpre[a] = (gd[a] * t[a].s) * other[a];
            arow[0][c - c0] = active ? bf16_round(prod) : 0.0f;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              arow[a + 1][c - c0] = active ? bf16_round(jpre[a]) : 0.0f;
            }

            // dP = B bf16(d enc), dJ_a = B bf16(d jac_a): row c of the block's B
            float dp = 0.0f, dJ[3] = {0.0f, 0.0f, 0.0f};
            const float4* brow = reinterpret_cast<const float4*>(b_s + (s * C + c) * F);
#pragma unroll
            for (int f4 = 0; f4 < F / 4; ++f4) {
              const float4 bv = brow[f4];
              const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int f = 4 * f4 + k;
                dp = fmaf(b[k], de[f], dp);
#pragma unroll
                for (int a = 0; a < 3; ++a) dJ[a] = fmaf(b[k], dj[a][f], dJ[a]);
              }
            }
            float gs[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) gs[a] = (dJ[a] * gd[a]) * t[a].s;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const int b1 = a == 0 ? 1 : 0;
              const int b2 = a == 2 ? 1 : 2;
              const float d_v = (dp * other[a] + gs[b1] * v[b2]) + gs[b2] * v[b1];
              const float d_gd = (dJ[a] * t[a].s) * other[a];
              acc_u[a] = acc_u[a] + d_v * gd[a];
              dvr[a][q] = bf16_round(d_v);
              dgr[a][q] = bf16_round(d_gd);
            }
          }
          if (active) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              float* dst = drow0[a] + 4 * c4;
              const float w0 = t[a].w0, w1 = t[a].w1;
              atomic_add4(dst, w0 * dvr[a][0] - dgr[a][0], w0 * dvr[a][1] - dgr[a][1],
                          w0 * dvr[a][2] - dgr[a][2], w0 * dvr[a][3] - dgr[a][3]);
              atomic_add4(dst + LD, w1 * dvr[a][0] + dgr[a][0], w1 * dvr[a][1] + dgr[a][1],
                          w1 * dvr[a][2] + dgr[a][2], w1 * dvr[a][3] + dgr[a][3]);
            }
          }
        }

        // d B of the component tile over the sample tile: 4 x kBwdTile staged
        // (component row, F-row) pairs
        __syncthreads();
        reduce_tile<L::CT, F, L::LDA, L::LDG, L::ROWS>(a_s, g_s, acc + (s * C + c0) * F,
                                                       nullptr);
      }
    }
    if (active) {
#pragma unroll
      for (int a = 0; a < 3; ++a) du[a * n + i] = acc_u[a] * t[a].s;
    }
  }
  __syncthreads();
  flush_acc(acc, S * C * F, dbasis);
}

template <int C, int F, int S>
int launch_jac_basis_bwd(const float* u3, long long n, int r, const void* vsave,
                         const void* gdsave, const float* denc, const float* djac,
                         const void* basis, float* dlines, float* du, float* dbasis,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * JacBwdSmem<C, F, S>::FLOATS;
  return launch_tiles(cp_jac_basis_bwd_kernel<C, F, S>, n, smem, stream, u3, n, r,
                      static_cast<const __nv_bfloat16*>(vsave),
                      static_cast<const __nv_bfloat16*>(gdsave), denc, djac,
                      static_cast<const __nv_bfloat16*>(basis), dlines, du, dbasis);
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape. dlines and dbasis must be zeroed by the caller: the
// kernel adds into them.
extern "C" int cp_jac_basis_bwd(const float* u3, long long n, int r, int c, int f,
                                const void* vsave, const void* gdsave, const float* denc,
                                const float* djac, const void* basis, float* dlines,
                                float* du, float* dbasis, void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_JACB_BWD_CASE(C_, F_)                                                  \
  if (c == C_ && f == F_)                                                           \
    return insr::launch_jac_basis_bwd<C_, F_, 1>(u3, n, r, vsave, gdsave, denc, djac, \
                                                 basis, dlines, du, dbasis, st);
  INSR_JACB_BWD_CASE(128, 16)  // the bench NeuS SDF encoding at bench.py --encoding cp_big
  INSR_JACB_BWD_CASE(64, 16)   // the bench NeuS SDF encoding
  INSR_JACB_BWD_CASE(16, 8)   // the small test model
#undef INSR_JACB_BWD_CASE
  return -1;
}

// K12, the stacked-scales backward: r = R_max; dlines is the (3, R_max, S*C)
// f32 fine gradient table and dbasis the (S, C, F) diagonal blocks, both zeroed
// by the caller; the other operands as cp_jac_stacked_fwd writes and reads them.
extern "C" int cp_jac_stacked_bwd(const float* u3, long long n, int r, int c, int f,
                                  int n_scales, const void* vsave, const void* gdsave,
                                  const float* denc, const float* djac, const void* basis,
                                  float* dlines, float* du, float* dbasis, void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_JACS_BWD_CASE(C_, F_, S_)                                               \
  if (c == C_ && f == F_ && n_scales == S_)                                          \
    return insr::launch_jac_basis_bwd<C_, F_, S_>(u3, n, r, vsave, gdsave, denc, djac, \
                                                  basis, dlines, du, dbasis, st);
  INSR_JACS_BWD_CASE(64, 16, 2)  // the bench NeuS SDF encoding, cp_stacked
  INSR_JACS_BWD_CASE(16, 8, 2)   // the small test model
#undef INSR_JACS_BWD_CASE
  return -1;
}
