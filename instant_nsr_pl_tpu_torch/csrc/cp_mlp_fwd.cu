// Fused CP-encode -> basis -> bf16 ReLU MLP forward (the NeRF density head).
//
// Replaces: instant_nsr_pl_tpu/ops/cp_mlp_pallas.py cp_mlp_apply -> _fwd_impl
// -> _fwd_kernel (pallas_call at :267). Eval launches write only `out`;
// training launches also write the TPU kernel's residuals for the backward
// (csrc/cp_mlp_bwd.cu): vsave (3, S*C, N) bf16, the interpolated line values
// v of every axis, and hsave (NH, W, N) bf16, the hidden activations. They
// are saved rather than recomputed in the backward: that keeps the backward
// free of the line-table reads and the forward MLP, and lets the tests and
// chip_smoke.py hand the same residuals to the kernel and to its plain
// version (cp_mlp.py cp_mlp_backward_plain), so a bf16 rounding difference
// cannot flip a ReLU mask between the two.
//
// What it computes, per sample x (already contracted into [0,1]^3), scale s
// and axis a:
//   p = clip(x_a, 0, 1) * (R_s - 1), i0 = min(floor(p), R_s - 2)
//   v_a = w0 * L_{s,a}[i0] + w1 * L_{s,a}[i0 + 1]   (f32 sum), with the bf16
//   tent weights w_r = bf16(max(0, 1 - |r - p|)) of cp_common.cuh
//   prod_s = bf16((v_x * v_y) * v_z)                               (C values)
//   enc[s*F + j] = sum_c B_s[c][j] * prod_s[c]                     (f32 sum)
// then the packed MLP of mlp_common.cuh. Lines and basis are bf16. This is
// exactly the TPU kernel's dense (C, R) x (R, BN) "tent" matmul: the tent
// column has its two non-zeros at i0 and i0+1 with those bf16 weights (also
// on an interior knot, where w1 = 0, and at p = R-1, where w0 = 0), and both
// products are exact in f32, so v matches to the bit.
//
// What bounds it on an H100: neither HBM nor arithmetic at this size in eval
// mode. The function must move ~76 B per sample (12 B in, 64 B out at D = 16),
// about 6 us at 3.35 TB/s for 262,144 samples, and does ~12k flops per sample
// on the CUDA cores; training mode adds 896 B of residuals per sample (70 us).
// The TPU needed the dense tent matmul because it has no vector gather;
// Hopper has one, so each thread reads its 2 x 3 x S line rows (C bf16 = 128 B
// each at C = 64) straight from global memory through L1/L2: the tables (48 KB
// coarse, 768 KB fine at the bench shape) stay resident in the 50 MB L2, and
// row reads are 16-byte vector loads. The basis and the packed MLP are widened
// to f32 in shared memory once per block and read as warp-wide broadcasts. A
// thread per sample keeps every intermediate in registers; residual stores are
// coalesced across a warp (neighbouring samples are neighbouring addresses).
// Tensor cores, TMA and pipelining are left for a later change.
//
// Stacked scales (K13): the same kernel, instantiated with STACKED = true,
// replaces cp_mlp_pallas.py cp_mlp_apply_stacked -> _fwd_impl_stacked ->
// _fwd_kernel_stacked (pallas_call at :531). When every resolution is nested
// in the finest ((R_max - 1) a multiple of every R_s - 1), each coarse line is
// upsampled exactly onto the fine grid (ops/cp_stacked.py) and all scales'
// components sit side by side in one (3, R_max, S*C) bf16 table. A sample then
// computes one tent per axis at R_max for all scales and reads two S*C-wide
// rows per axis (256 B each at the bench shape). The TPU projects through the
// (E, S*C) block-diagonal basis; here output block s sums only components
// s*C .. s*C+C-1 (the (S, C, F) diagonal blocks), skipping exact zeros. The
// residual vsave keeps the (3, S*C, N) layout of K1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (explicit
// fmaf only, so elementwise rounding follows the plain PyTorch version).

#include "cp_common.cuh"

namespace insr {

constexpr int kMaxScales = 4;
constexpr int kCpBlock = 128;

// Per scale: the first row's component 0 and the resolution. Per-scale tables
// are (3, R_s, C) bf16; STACKED tables are one (3, R_max, S*C) bf16 table with
// ptr[s] at its column s*C and res[s] = R_max.
struct LineTables {
  const __nv_bfloat16* ptr[kMaxScales];
  int res[kMaxScales];
};

template <int C, int F, int S, int W, int NH, int D, bool STACKED>
__global__ void __launch_bounds__(kCpBlock)
    cp_mlp_fwd_kernel(const float* __restrict__ x, long long n,
                      LineTables lines, const __nv_bfloat16* __restrict__ basis,
                      const __nv_bfloat16* __restrict__ ws,
                      const float* __restrict__ bs, float* __restrict__ out,
                      __nv_bfloat16* __restrict__ vsave,
                      __nv_bfloat16* __restrict__ hsave) {
  constexpr int E = S * F;
  constexpr int ROWS = E + NH * W;
  constexpr int OUT4 = round_up4(D);
  constexpr int LD = STACKED ? S * C : C;  // row stride of a line table
  static_assert(C % 8 == 0 && F % 4 == 0 && W % 4 == 0, "layout");

  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* b_s = w_s + ROWS * W;
  float* basis_s = b_s + (NH + 1) * W;  // (S, C, F)
  load_bf16_to_shared(ws, ROWS * W, w_s);
  load_f32_to_shared(bs, (NH + 1) * W, b_s);
  load_bf16_to_shared(basis, S * C * F, basis_s);
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float u[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
    float enc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) enc[e] = 0.0f;

    Tent t[3];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = lines.res[s];
      // stacked scales share the fine grid: one tent per axis for all of them
      if (!STACKED || s == 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) t[a] = tent(u[a], r);
      }
      const uint4* row0[3];
      const uint4* row1[3];
      float w0[3], w1[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        w0[a] = t[a].w0;
        w1[a] = t[a].w1;
        const __nv_bfloat16* base =
            lines.ptr[s] + (static_cast<long long>(a) * r + t[a].i0) * LD;
        row0[a] = reinterpret_cast<const uint4*>(base);
        row1[a] = reinterpret_cast<const uint4*>(base + LD);
      }
#pragma unroll
      for (int c8 = 0; c8 < C / 8; ++c8) {
        uint4 q0[3], q1[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          q0[a] = __ldg(row0[a] + c8);
          q1[a] = __ldg(row1[a] + c8);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float v[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            v[a] = fmaf(w1[a], bf16_at(q1[a], k), w0[a] * bf16_at(q0[a], k));
          }
          if (vsave != nullptr) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              vsave[(static_cast<long long>(a * S + s) * C + c8 * 8 + k) * n + i] =
                  __float2bfloat16_rn(v[a]);
            }
          }
          const float prod = bf16_round((v[0] * v[1]) * v[2]);
          const float4* brow =
              reinterpret_cast<const float4*>(basis_s + (s * C + c8 * 8 + k) * F);
#pragma unroll
          for (int j4 = 0; j4 < F / 4; ++j4) {
            const float4 bv = brow[j4];
            float* e4 = enc + s * F + 4 * j4;
            e4[0] = fmaf(bv.x, prod, e4[0]);
            e4[1] = fmaf(bv.y, prod, e4[1]);
            e4[2] = fmaf(bv.z, prod, e4[2]);
            e4[3] = fmaf(bv.w, prod, e4[3]);
          }
        }
      }
    }

    float o[OUT4];
    mlp_forward<E, W, NH, OUT4>(w_s, b_s, enc, o, hsave, n, i);
    store_row<D, OUT4>(out + i * D, o);
  }
}

template <int C, int F, int S, int W, int NH, int D, bool STACKED>
int launch_cp(const float* x, long long n, const LineTables& lines,
              const void* basis, const void* ws, const float* bs, float* out,
              void* vsave, void* hsave, cudaStream_t stream) {
  constexpr int ROWS = S * F + NH * W;
  const size_t smem =
      sizeof(float) * (ROWS * W + (NH + 1) * W + S * C * F);
  return launch(cp_mlp_fwd_kernel<C, F, S, W, NH, D, STACKED>, n, kCpBlock, smem,
                stream, x, n, lines,
                static_cast<const __nv_bfloat16*>(basis),
                static_cast<const __nv_bfloat16*>(ws), bs, out,
                static_cast<__nv_bfloat16*>(vsave), static_cast<__nv_bfloat16*>(hsave));
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape (the Python wrapper lists the supported ones). vsave and
// hsave are both nullptr (eval) or both the residual buffers (training).
extern "C" int cp_mlp_fwd(const float* x, long long n, const void* const* line_ptrs,
                          const int* res, int n_scales, const void* basis,
                          const void* ws, const float* bs, float* out, int c,
                          int f, int w, int n_hidden, int d, void* vsave,
                          void* hsave, void* stream) {
  insr::LineTables lines{};
  if (n_scales < 1 || n_scales > insr::kMaxScales) return -1;
  for (int s = 0; s < n_scales; ++s) {
    lines.ptr[s] = static_cast<const __nv_bfloat16*>(line_ptrs[s]);
    lines.res[s] = res[s];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_CP_CASE(C_, F_, S_, W_, NH_, D_)                                 \
  if (c == C_ && f == F_ && n_scales == S_ && w == W_ && n_hidden == NH_ &&   \
      d == D_)                                                                \
    return insr::launch_cp<C_, F_, S_, W_, NH_, D_, false>(x, n, lines, basis, ws, \
                                                           bs, out, vsave, hsave, st);
  INSR_CP_CASE(64, 16, 2, 64, 1, 16)   // the bench NeRF density head
  INSR_CP_CASE(128, 16, 3, 64, 1, 16)  // the same head on bench.py --encoding cp_big
  INSR_CP_CASE(16, 8, 2, 32, 1, 16)   // the small test model
  INSR_CP_CASE(16, 8, 2, 32, 2, 16)
#undef INSR_CP_CASE
  return -1;
}

// K13, the stacked-scales forward: `lines` is the (3, R_max, S*C) bf16 fine
// table of every scale, r = R_max; otherwise as cp_mlp_fwd.
extern "C" int cp_mlp_stacked_fwd(const float* x, long long n, const void* lines, int r,
                                  int n_scales, const void* basis, const void* ws,
                                  const float* bs, float* out, int c, int f, int w,
                                  int n_hidden, int d, void* vsave, void* hsave,
                                  void* stream) {
  insr::LineTables tables{};
  if (n_scales < 1 || n_scales > insr::kMaxScales || r < 2) return -1;
  for (int s = 0; s < n_scales; ++s) {
    tables.ptr[s] = static_cast<const __nv_bfloat16*>(lines) + s * c;
    tables.res[s] = r;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_CPS_CASE(C_, F_, S_, W_, NH_, D_)                                  \
  if (c == C_ && f == F_ && n_scales == S_ && w == W_ && n_hidden == NH_ &&     \
      d == D_)                                                                  \
    return insr::launch_cp<C_, F_, S_, W_, NH_, D_, true>(x, n, tables, basis, ws, \
                                                          bs, out, vsave, hsave, st);
  INSR_CPS_CASE(64, 16, 2, 64, 1, 16)  // the bench NeRF density head, cp_stacked
  INSR_CPS_CASE(16, 8, 2, 32, 1, 16)   // the small test model
  INSR_CPS_CASE(16, 8, 2, 32, 2, 16)
#undef INSR_CPS_CASE
  return -1;
}
