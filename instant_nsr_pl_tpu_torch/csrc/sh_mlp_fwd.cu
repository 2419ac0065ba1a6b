// Fused SH-encode -> concat -> bf16 ReLU MLP forward (the NeRF radiance head).
//
// Replaces: instant_nsr_pl_tpu/ops/sh_mlp_pallas.py sh_mlp_apply -> _fwd_impl
// -> _fwd_kernel + _kernel_sh (pallas_call at :195). Eval launches write only
// `out`; training launches also write the TPU kernel's residual hsave (NH, W,
// N) bf16, the hidden activations, which the backward (csrc/sh_mlp_bwd.cu)
// reads; it recomputes SH from the directions, as the TPU backward does.
//
// What it computes, per sample: the real SH basis of degree DEG in f32 from
// the raw unit direction (the constants of ops/sh.py, the expressions of
// _kernel_sh), the MLP input [features | zero padding to FPAD | SH] and the
// packed MLP of mlp_common.cuh. The host packs the first layer's rows in that
// order (ops/sh_mlp.py: _perm puts extras such as NeuS normals right after the
// features, and zero rows fill the padding), so the composed order
// [features | SH | extras] of the weights is kept by the caller.
//
// What bounds it on an H100: HBM. The function must move 16 x 4 B features,
// 12 B of direction and 12 B of colour per sample at the bench shape, ~23 MB
// or about 7 us at 3.35 TB/s for 262,144 samples, against ~12.7k flops per
// sample. A thread per sample reads its feature row and direction once,
// evaluates SH and the whole MLP in registers (weights widened to f32 in
// shared memory once per block, read as warp-wide broadcasts) and writes its
// colour once, so nothing else touches device memory. The ragged edge is
// masked by the grid-stride loop instead of padding the inputs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (explicit
// fmaf only, so the SH polynomials round as the plain PyTorch version does).

#include "mlp_common.cuh"
#include "sh_common.cuh"

namespace insr {

constexpr int kShBlock = 128;

template <int FPAD, int DEG, int W, int NH, int D>
__global__ void __launch_bounds__(kShBlock)
    sh_mlp_fwd_kernel(const float* __restrict__ feat, int n_feat,
                      const float* __restrict__ dirs, long long n,
                      const __nv_bfloat16* __restrict__ ws,
                      const float* __restrict__ bs, float* __restrict__ out,
                      __nv_bfloat16* __restrict__ hsave) {
  constexpr int DIN = FPAD + DEG * DEG;
  constexpr int ROWS = DIN + NH * W;
  constexpr int OUT4 = round_up4(D);

  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  float* b_s = w_s + ROWS * W;
  load_bf16_to_shared(ws, ROWS * W, w_s);
  load_f32_to_shared(bs, (NH + 1) * W, b_s);
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float x0[DIN];
    const float* fr = feat + i * n_feat;
#pragma unroll
    for (int k = 0; k < FPAD; ++k) x0[k] = k < n_feat ? fr[k] : 0.0f;
    sh_basis<DEG>(dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2], x0 + FPAD);

    float o[OUT4];
    mlp_forward<DIN, W, NH, OUT4>(w_s, b_s, x0, o, hsave, n, i);
    store_row<D, OUT4>(out + i * D, o);
  }
}

template <int FPAD, int DEG, int W, int NH, int D>
int launch_sh(const float* feat, int n_feat, const float* dirs, long long n,
              const void* ws, const float* bs, float* out, void* hsave,
              cudaStream_t stream) {
  constexpr int ROWS = FPAD + DEG * DEG + NH * W;
  const size_t smem = sizeof(float) * (ROWS * W + (NH + 1) * W);
  return launch(sh_mlp_fwd_kernel<FPAD, DEG, W, NH, D>, n, kShBlock, smem,
                stream, feat, n_feat, dirs, n,
                static_cast<const __nv_bfloat16*>(ws), bs, out,
                static_cast<__nv_bfloat16*>(hsave));
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape (the Python wrapper lists the supported ones). hsave is
// nullptr (eval) or the (NH, W, n) bf16 residual buffer (training).
extern "C" int sh_mlp_fwd(const float* feat, int n_feat, int fpad,
                          const float* dirs, long long n, int degree,
                          const void* ws, const float* bs, float* out, int w,
                          int n_hidden, int d, void* hsave, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_feat < 0 || n_feat > fpad) return -1;
#define INSR_SH_CASE(FPAD_, DEG_, W_, NH_, D_)                                \
  if (fpad == FPAD_ && degree == DEG_ && w == W_ && n_hidden == NH_ &&        \
      d == D_)                                                                \
    return insr::launch_sh<FPAD_, DEG_, W_, NH_, D_>(feat, n_feat, dirs, n,  \
                                                     ws, bs, out, hsave, st);
  INSR_SH_CASE(16, 4, 64, 2, 3)  // the bench NeRF radiance head
  INSR_SH_CASE(16, 4, 32, 2, 3)  // the small test models
  INSR_SH_CASE(24, 4, 32, 2, 3)  // 16 features + 3 extras
#undef INSR_SH_CASE
  return -1;
}
