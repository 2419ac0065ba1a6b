// Fused SH-encode -> concat -> bf16 ReLU MLP forward (the NeRF radiance head, K3).
//
// Replaces: instant_nsr_pl_tpu/ops/sh_mlp_pallas.py sh_mlp_apply -> _fwd_impl
// -> _fwd_kernel + _kernel_sh (pallas_call at :195). Eval launches write only
// `out`; training launches also write the TPU kernel's residual hsave (NH, W,
// N) bf16, the hidden activations, which the backward (csrc/sh_mlp_bwd.cu K4)
// reads; K4 recomputes SH from the directions, as the TPU backward does.
//
// What it computes, per sample: the real SH basis of degree DEG in f32 from
// the raw unit direction (sh_common.cuh: the constants of ops/sh.py and the
// expressions of _kernel_sh, so SH equals the plain version's to the bit),
// the MLP input [features | zero padding to FPAD | SH] rounded to bf16 and
// the bf16 ReLU MLP: each layer's products bf16 x bf16 with f32 sums, the f32
// bias added after the sum, ReLU and a bf16 rounding of every hidden
// activation (hsave); the output layer stays f32. The host packs the first
// layer's rows in that order (ops/sh_mlp.py: _perm puts extras such as NeuS
// normals right after the features, and zero rows fill the padding), so the
// composed order [features | SH | extras] of the weights is kept by the
// caller. The sums run in the tensor cores' order, not the plain version's:
// `out` agrees to f32 rounding, and an hsave entry differs where the other
// order flips its bf16 rounding (2e-5 of the entries at the bench shape,
// chip_smoke.py on an NVIDIA H100).
//
// What bounds it on an H100: HBM. Per sample it must read 64 B of features and
// 12 B of direction and write 12 B of colour (88 B: 0.0069 ms for 262,144
// samples at 3.35 TB/s), plus 256 B of hsave in training mode (344 B:
// 0.0269 ms). Its ~6.3k multiply-adds a sample are ~3 us of bf16 tensor-core
// time; on the CUDA cores, a thread per sample, each of them would read its
// weight from shared memory, which an SM issues at a quarter of its FMA rate
// (~0.2 ms), so the products run on the tensor cores.
//
// Design (tensor cores, csrc/mma_common.cuh, as csrc/cp_mlp_fwd.cu K1):
// persistent blocks of 8 warps walk tiles of 64 samples; warp w owns the
// tile's samples 8w .. 8w+7 from the loads to the colour, so eval mode needs
// no block barrier.
// - Loads: the warp's 8 feature rows are one contiguous run of 8 n_feat
//   floats, read with coalesced 4-byte loads (n_feat = 19 rows, NeuS's 16
//   features and 3 normals, are not 16-byte aligned) and rounded to bf16 into
//   a swizzled [k][sample] tile; each group of 4 lanes reads one sample's
//   direction, evaluates the whole basis and writes its quarter of it.
// - Layers on mma.sync m16n8k16 (units as M, the warp's 8 samples as N):
//   H_l^T = W_l^T A^T with the bf16 weights in shared memory once per block
//   (layer 0's rows padded with zero rows to a multiple of 16); bias, ReLU and
//   the bf16 rounding on the fragments, into a swizzled [l*W + unit][sample]
//   tile. The output layer is one m-tile of 16 units: the packed weights'
//   zero columns past D.
// - Writes: a warp stages its 8 samples' colours in shared memory and writes
//   them as one contiguous run of 8 D floats (whole 32-byte sectors at D = 3);
//   in training mode, after a block barrier, the block writes each 64-sample
//   row of hsave (128 contiguous bytes) as eight 16-byte streaming stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (explicit
// fmaf only, so the SH polynomials round as the plain PyTorch version does).

#include "mma_common.cuh"
#include "sh_common.cuh"

namespace insr {

template <int FPAD, int DEG, int W, int NH, int D>
struct ShFwd {
  static constexpr int NSH = DEG * DEG;
  static constexpr int DIN = FPAD + NSH;           // rows of layer 0 in the pack
  static constexpr int DINP = round_up(DIN, 16);   // ... padded with zero rows in shared memory
  static constexpr int LDW = W + 8;                // weight row stride in shared memory
  static constexpr int SPW = kT / kWarps;          // samples per warp (its mma n-tile)
  // shared memory, in bf16 elements
  static constexpr int WT = (DINP + NH * W) * LDW;
  static constexpr int X0 = DINP * kT;
  static constexpr int HB = NH * W * kT;
  static constexpr int CO = 2 * kWarps * SPW * D;  // the colour stage, f32
  static constexpr size_t BYTES = 2 * (WT + X0 + HB + CO);
  static_assert(W % 16 == 0 && D <= 16 && D <= W && NH >= 1 && FPAD % 8 == 0, "layout");
};

template <int FPAD, int DEG, int W, int NH, int D, bool TRAIN>
__global__ void __launch_bounds__(kThreads, 2)
    sh_mlp_fwd_kernel(const float* __restrict__ feat, int n_feat,
                      const float* __restrict__ dirs, long long n,
                      const __nv_bfloat16* __restrict__ ws, const float* __restrict__ bs,
                      float* __restrict__ out, __nv_bfloat16* __restrict__ hsave) {
  using K = ShFwd<FPAD, DEG, W, NH, D>;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* x0 = wt + K::WT;  // bf16 MLP input, swizzled [k][sample]
  __nv_bfloat16* hb = x0 + K::X0;  // hidden activations, swizzled [l*W + unit][sample]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_in = lane >> 2, c_in = (lane & 3) * 2;
  const int tw = warp * K::SPW;  // the warp's first sample of the tile
  const int tc = tw + c_in;      // this thread's fragment samples tc, tc + 1
  float* co = reinterpret_cast<float*>(hb + K::HB) + warp * K::SPW * D;  // [sample][d]

  // the packed weights: layer 0's DIN rows, zero rows to DINP, the other layers
  for (int q = threadIdx.x; q < (K::DINP + NH * W) * (W / 8); q += kThreads) {
    const int r = q / (W / 8), ch = q % (W / 8);
    const int src = r < K::DIN ? r : r >= K::DINP ? r - K::DINP + K::DIN : -1;
    *reinterpret_cast<uint4*>(wt + r * K::LDW + ch * 8) =
        src >= 0 ? *reinterpret_cast<const uint4*>(ws + src * W + ch * 8) : make_uint4(0, 0, 0, 0);
  }
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int q = threadIdx.x; q < (K::DINP - K::DIN) * kT; q += kThreads) {
    x0[swz(K::DIN + q / kT, q % kT)] = zero;  // the input's padding rows stay zero
  }
  __syncthreads();

  const long long ntiles = (n + kT - 1) / kT;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long s0 = tile * kT;
    const int nv = static_cast<int>(n - s0 < kT ? n - s0 : kT);
    const int nw = nv - tw < 0 ? 0 : nv - tw < K::SPW ? nv - tw : K::SPW;  // the warp's samples
    // features: the warp's rows are 8 n_feat contiguous floats
    const float* fw = feat + (s0 + tw) * n_feat;
#pragma unroll
    for (int q = lane; q < K::SPW * FPAD; q += 32) {
      const int g = q / FPAD, k = q % FPAD;
      const float v = g < nw && k < n_feat ? fw[g * n_feat + k] : 0.0f;
      x0[swz(k, tw + g)] = __float2bfloat16_rn(v);
    }
    // SH: 4 lanes per sample, each writes a quarter of its basis
    {
      const int g = lane >> 2, p = lane & 3;
      float d[3] = {0.0f, 0.0f, 0.0f};
      if (g < nw) {
#pragma unroll
        for (int a = 0; a < 3; ++a) d[a] = dirs[3 * (s0 + tw + g) + a];
      }
      float sh[K::NSH];
      sh_basis<DEG>(d[0], d[1], d[2], sh);
#pragma unroll
      for (int k = 0; k < K::NSH; ++k) {
        if (k % 4 == p) x0[swz(FPAD + k, tw + g)] = __float2bfloat16_rn(sh[k]);
      }
    }
    __syncwarp();  // the warp's input columns are staged
    // hidden layers: H_l^T = W_l^T A^T, bias, ReLU, bf16 into rows l*W of hb
    static_for<0, NH>([&](auto lc) {
      constexpr int l = decltype(lc)::value;
      constexpr int KD = l == 0 ? K::DINP : W;
      constexpr int ROW0 = l == 0 ? 0 : K::DINP + (l - 1) * W;
      const __nv_bfloat16* ain = l == 0 ? x0 : hb;
      constexpr int ain0 = l == 0 ? 0 : (l - 1) * W;
      float z[W / 16][4];
#pragma unroll
      for (int mt = 0; mt < W / 16; ++mt) z[mt][0] = z[mt][1] = z[mt][2] = z[mt][3] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < KD; k0 += 16) {
        uint32_t bf[2];
        load_b_swz(bf, ain, ain0 + k0, tw, lane);
#pragma unroll
        for (int mt = 0; mt < W / 16; ++mt) {
          uint32_t af[4];
          load_a_t(af, wt + ROW0 * K::LDW, K::LDW, k0, mt * 16, lane);
          mma_bf16(z[mt], af, bf);
        }
      }
#pragma unroll
      for (int mt = 0; mt < W / 16; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int unit = mt * 16 + r_in + 8 * half;
          const float b = __ldg(bs + l * W + unit);
          *reinterpret_cast<uint32_t*>(hb + swz(l * W + unit, tc)) =
              pack_bf16x2(fmaxf(z[mt][2 * half] + b, 0.0f), fmaxf(z[mt][2 * half + 1] + b, 0.0f));
        }
      }
      __syncwarp();  // layer l's columns are staged for the next layer
    });
    // output layer: units 0..15 (the pack's columns past D are zero), f32
    {
      constexpr int ROW0 = K::DINP + (NH - 1) * W;
      float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k0 = 0; k0 < W; k0 += 16) {
        uint32_t af[4], bf[2];
        load_b_swz(bf, hb, (NH - 1) * W + k0, tw, lane);
        load_a_t(af, wt + ROW0 * K::LDW, K::LDW, k0, 0, lane);
        mma_bf16(o, af, bf);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = r_in + 8 * half;
        if (d < D) {
          const float b = __ldg(bs + NH * W + d);
          co[c_in * D + d] = o[2 * half] + b;
          co[(c_in + 1) * D + d] = o[2 * half + 1] + b;
        }
      }
      __syncwarp();
      for (int q = lane; q < nw * D; q += 32) out[(s0 + tw) * D + q] = co[q];
      __syncwarp();  // the stage may take the next tile's colours
    }
    if constexpr (TRAIN) {
      __syncthreads();  // every warp's hidden columns are staged
      store_tile_rows(hb, hsave, n, s0, nv, NH * W, [](int row) { return row; });
      __syncthreads();  // the next tile may overwrite them
    }
  }
}

template <int FPAD, int DEG, int W, int NH, int D>
int launch_sh(const float* feat, int n_feat, const float* dirs, long long n, const void* ws,
              const float* bs, float* out, void* hsave, int* info, cudaStream_t stream) {
  using K = ShFwd<FPAD, DEG, W, NH, D>;
  const bool train = hsave != nullptr;
  auto kernel = train ? sh_mlp_fwd_kernel<FPAD, DEG, W, NH, D, true>
                      : sh_mlp_fwd_kernel<FPAD, DEG, W, NH, D, false>;
  int plan[3];
  int* p = info != nullptr ? info : plan;
  const int rc = plan_persistent(reinterpret_cast<const void*>(kernel), K::BYTES, n, p);
  if (rc != 0) return rc;
  if (n > 0) {
    kernel<<<p[0], kThreads, K::BYTES, stream>>>(feat, n_feat, dirs, n,
                                                 static_cast<const __nv_bfloat16*>(ws), bs, out,
                                                 static_cast<__nv_bfloat16*>(hsave));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape (the Python wrapper lists the supported ones). hsave is
// nullptr (eval) or the (NH, W, n) bf16 residual buffer (training). info
// (nullptr or 3 ints) receives the launch plan: grid, blocks per SM and
// shared-memory bytes per block.
extern "C" int sh_mlp_fwd(const float* feat, int n_feat, int fpad, const float* dirs,
                          long long n, int degree, const void* ws, const float* bs, float* out,
                          int w, int n_hidden, int d, void* hsave, int* info, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_feat < 0 || n_feat > fpad) return -1;
#define INSR_SH_CASE(FPAD_, DEG_, W_, NH_, D_)                                              \
  if (fpad == FPAD_ && degree == DEG_ && w == W_ && n_hidden == NH_ && d == D_)             \
    return insr::launch_sh<FPAD_, DEG_, W_, NH_, D_>(feat, n_feat, dirs, n, ws, bs, out, hsave, \
                                                     info, st);
  INSR_SH_CASE(16, 4, 64, 2, 3)  // the bench NeRF radiance head; NeuS: 13 features + 3 normals
  INSR_SH_CASE(16, 4, 32, 2, 3)  // the small test models
  INSR_SH_CASE(24, 4, 32, 2, 3)  // 16 features + 3 extras
#undef INSR_SH_CASE
  return -1;
}
