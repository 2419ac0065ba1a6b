// CP line product forward (K5): prod (C, N) = v_x * v_y * v_z.
//
// Replaces: instant_nsr_pl_tpu/ops/cp_pallas.py cp_product ->
// _cp_product_fwd_impl -> _fwd_kernel (pallas_call at :242). The unfused CP
// encode of ops/cp.py impl="fast": the NeuS occupancy update and the
// finite-difference SDF run it once per scale; the basis projection follows
// on the host. Eval launches write only `prod`; training launches also write
// the TPU kernel's residual vsave (3, C, N) bf16, the interpolated line values
// that the backward (K6, csrc/cp_jac_basis_bwd.cu) reads.
//
// What it computes, per sample u (3, N) and axis a, with the tent
// coordinates of cp_common.cuh on the (3, R, C) bf16 line stack L:
//   v_a[c] = w0 * L_a[i0][c] + w1 * L_a[i0 + 1][c]      (f32, one rounding)
//   prod[c] = (v_x[c] * v_y[c]) * v_z[c]
// which equals the TPU kernel's dense (C, R) x (R, BN) tent matmul to the
// bit: the tent column has two non-zeros, both products are exact in f32.
//
// What bounds it on an H100: HBM. The function reads u (12 B) and writes prod
// (4 B x C) per sample, 268 B at C = 64, and in training mode vsave (6 B x C)
// more, 652 B: 21 us and 51 us at 3.35 TB/s for 262,144 samples. The tables
// (48 KB at R = 128, 768 KB at R = 2048) stay in the 50 MB L2. A thread per
// sample reads its 2 x 3 rows with 16-byte loads and writes its C products
// and residuals in the (C, N) layout, so each store instruction is coalesced
// across the warp (neighbouring threads hold neighbouring samples).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (explicit
// fmaf only, so each rounding follows the plain PyTorch version).

#include "cp_common.cuh"

namespace insr {

constexpr int kProdBlock = 128;

template <int C>
__global__ void __launch_bounds__(kProdBlock)
    cp_product_fwd_kernel(const float* __restrict__ u3, long long n,
                          const __nv_bfloat16* __restrict__ lines, int r,
                          float* __restrict__ prod, __nv_bfloat16* __restrict__ vsave) {
  static_assert(C % 8 == 0, "rows are read as 16-byte vectors");
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint4* row0[3];
    float w0[3], w1[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const Tent t = tent(u3[a * n + i], r);
      w0[a] = t.w0;
      w1[a] = t.w1;
      row0[a] = reinterpret_cast<const uint4*>(
          lines + (static_cast<long long>(a) * r + t.i0) * C);
    }
#pragma unroll 2
    for (int c8 = 0; c8 < C / 8; ++c8) {
      uint4 q0[3], q1[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        q0[a] = __ldg(row0[a] + c8);
        q1[a] = __ldg(row0[a] + C / 8 + c8);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = c8 * 8 + k;
        float v[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          v[a] = fmaf(w1[a], bf16_at(q1[a], k), w0[a] * bf16_at(q0[a], k));
        }
        prod[static_cast<long long>(c) * n + i] = (v[0] * v[1]) * v[2];
        if (vsave != nullptr) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            vsave[(static_cast<long long>(a) * C + c) * n + i] = __float2bfloat16_rn(v[a]);
          }
        }
      }
    }
  }
}

template <int C>
int launch_product(const float* u3, long long n, const void* lines, int r, float* prod,
                   void* vsave, cudaStream_t stream) {
  return launch(cp_product_fwd_kernel<C>, n, kProdBlock, 0, stream, u3, n,
                static_cast<const __nv_bfloat16*>(lines), r, prod,
                static_cast<__nv_bfloat16*>(vsave));
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape (the Python wrapper lists the supported ones). vsave is
// nullptr (eval) or the (3, C, N) bf16 residual (training).
extern "C" int cp_product_fwd(const float* u3, long long n, const void* lines, int r, int c,
                              float* prod, void* vsave, void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 128) return insr::launch_product<128>(u3, n, lines, r, prod, vsave, st);  // cp_big
  if (c == 64) return insr::launch_product<64>(u3, n, lines, r, prod, vsave, st);  // bench
  if (c == 16) return insr::launch_product<16>(u3, n, lines, r, prod, vsave, st);  // tests
  return -1;
}
