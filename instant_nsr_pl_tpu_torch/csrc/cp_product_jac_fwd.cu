// CP product with its analytic Jacobian, no basis (K7): prod (C, N) = v_x v_y v_z
// and jac (3, C, N), jac_a = d prod / d u_a.
//
// Replaces: instant_nsr_pl_tpu/ops/cp_pallas.py cp_product_jac ->
// _cp_product_jac_fwd_impl -> _jac_fwd_kernel (pallas_call at :424), the NeuS
// analytic-gradient path when the CP encoding has no basis (n_features: 0, the
// raw products; ops/cp.py cp_encode_with_jac). The Jacobian is a forward
// output, so the eikonal loss's second-order graph never differentiates
// through this op (its backward is csrc/cp_product_jac_bwd.cu). Training
// launches also write the TPU kernel's residuals vsave and gdsave (3, C, N)
// bf16; eval launches (a rendered view, export vertex colours) write neither.
//
// What it computes, per sample u (3, N), axis a and component c, with the
// tent coordinates of cp_common.cuh on the (3, R, C) bf16 line stack L:
//   v_a  = w0 * L_a[i0] + w1 * L_a[i0 + 1]            (f32, one rounding)
//   gd_a = L_a[i0 + 1] - L_a[i0]                      (the exact diff-hot product)
//   g_a  = gd_a * s_a,   s_a = (R - 1) * d clip(u_a)/du_a (0.5 at exact 0 or 1)
//   prod    = (v_x * v_y) * v_z
//   jac_x   = g_x * (v_y * v_z),  jac_y = g_y * (v_x * v_z),  jac_z = g_z * (v_x * v_y)
// in f32, as the TPU kernel's elementwise epilogue computes them after its
// two dense (C, R) x (R, BN) matmuls per axis (the tent and diff-hot columns
// have two non-zeros each, so a thread reads the two rows and weights them).
// gd is the right-derivative at an interior knot (i0 = floor(p)), as on the TPU.
//
// What bounds it on an H100: HBM. K7 is K9 (csrc/cp_jac_basis_fwd.cu) without
// the projection, so its outputs are C = 64 wide, not F = 16: per sample it
// reads u (12 B) and writes prod and jac (16 B x C = 1,024 B) and, training,
// vsave and gdsave (12 B x C = 768 B): 1,036 B eval and 1,804 B training, 81 us
// and 141 us at 3.35 TB/s for 262,144 samples. The tables (48 KB at R = 128,
// 768 KB at R = 2048) stay in the 50 MB L2. A thread per sample reads its 2 x 3
// rows with 16-byte loads and writes each output in the (C, N) layout, so every
// store instruction is coalesced across the warp (neighbouring threads hold
// neighbouring samples). No shared memory, no cross-sample work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "cp_common.cuh"

namespace insr {

constexpr int kProdJacBlock = 128;

template <int C>
__global__ void __launch_bounds__(kProdJacBlock)
    cp_product_jac_fwd_kernel(const float* __restrict__ u3, long long n,
                              const __nv_bfloat16* __restrict__ lines, int r,
                              float* __restrict__ prod, float* __restrict__ jac,
                              __nv_bfloat16* __restrict__ vsave,
                              __nv_bfloat16* __restrict__ gdsave) {
  static_assert(C % 8 == 0, "rows are read as 16-byte vectors");
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    Tent t[3];
    const uint4* row0[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      t[a] = tent(u3[a * n + i], r);
      row0[a] = reinterpret_cast<const uint4*>(
          lines + (static_cast<long long>(a) * r + t[a].i0) * C);
    }
#pragma unroll 1
    for (int c8 = 0; c8 < C / 8; ++c8) {
      uint4 q0[3], q1[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        q0[a] = __ldg(row0[a] + c8);
        q1[a] = __ldg(row0[a] + C / 8 + c8);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long c = c8 * 8 + k;
        float v[3], g[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float lo = bf16_at(q0[a], k), hi = bf16_at(q1[a], k);
          v[a] = fmaf(t[a].w1, hi, t[a].w0 * lo);
          const float gd = hi - lo;
          g[a] = gd * t[a].s;
          if (vsave != nullptr) {
            const long long off = (a * C + c) * n + i;
            vsave[off] = __float2bfloat16_rn(v[a]);
            gdsave[off] = __float2bfloat16_rn(gd);
          }
        }
        prod[c * n + i] = (v[0] * v[1]) * v[2];
        jac[c * n + i] = g[0] * (v[1] * v[2]);
        jac[(C + c) * n + i] = g[1] * (v[0] * v[2]);
        jac[(2 * C + c) * n + i] = g[2] * (v[0] * v[1]);
      }
    }
  }
}

template <int C>
int launch_product_jac(const float* u3, long long n, const void* lines, int r, float* prod,
                       float* jac, void* vsave, void* gdsave, cudaStream_t stream) {
  return launch(cp_product_jac_fwd_kernel<C>, n, kProdJacBlock, 0, stream, u3, n,
                static_cast<const __nv_bfloat16*>(lines), r, prod, jac,
                static_cast<__nv_bfloat16*>(vsave), static_cast<__nv_bfloat16*>(gdsave));
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape. vsave and gdsave are both nullptr (eval) or both the
// (3, C, N) bf16 residuals (training).
extern "C" int cp_product_jac_fwd(const float* u3, long long n, const void* lines, int r, int c,
                                  float* prod, float* jac, void* vsave, void* gdsave,
                                  void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 128)  // the raw products at bench.py --encoding cp_big's C
    return insr::launch_product_jac<128>(u3, n, lines, r, prod, jac, vsave, gdsave, st);
  if (c == 64)  // the raw-product NeuS SDF encoding
    return insr::launch_product_jac<64>(u3, n, lines, r, prod, jac, vsave, gdsave, st);
  if (c == 16)  // the small test model
    return insr::launch_product_jac<16>(u3, n, lines, r, prod, jac, vsave, gdsave, st);
  return -1;
}
