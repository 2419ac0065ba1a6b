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
// then the packed MLP: bf16(enc) W_0 + b_0 -> ReLU -> bf16 (hsave) -> ...
// -> W_NH + b_NH, f32 out. Lines, basis and weights are bf16. This is exactly
// the TPU kernel's dense (C, R) x (R, BN) "tent" matmul: the tent column has
// its two non-zeros at i0 and i0+1 with those bf16 weights (also on an
// interior knot, where w1 = 0, and at p = R-1, where w0 = 0), and both
// products are exact in f32, so v, prod and vsave match to the bit; the
// projection and the MLP sum their f32 products in the tensor cores' order.
//
// What bounds it on an H100: the line-row reads. The function must move
// ~76 B per sample (12 B in, 64 B out at D = 16; 6 us for 262,144 samples at
// 3.35 TB/s) plus 896 B of residuals in training mode (70 us), and its
// ~5,100 multiply-adds a sample (projection 2,048, MLP 3,072) are 3 us of
// bf16 tensor-core time. But every sample reads 2 x 3 x S rows of C bf16
// (128 B at C = 64) of the line tables: ~400 MB of L2 traffic at the bench
// shape, the tables themselves (48 KB coarse, 768 KB fine) staying L2-resident.
//
// Design: persistent blocks of 8 warps (mma_common.cuh) walk tiles of 64
// samples; warp w owns the tile's samples 8w .. 8w+7 from the gather to the
// output, so in eval mode a tile needs no block barrier.
// - Gather: C/8 lanes read one 128-byte row together (16 bytes each: a warp
//   instruction loads whole rows), all of a scale's rows for the warp's
//   samples in flight at once; each lane interpolates its 8 components with
//   the arithmetic above (--fmad=false, explicit fmaf) and stores bf16(prod)
//   as one 16-byte row chunk of a [sample][component] tile.
// - Projection on the tensor cores (mma.sync m16n8k16): enc_s^T = B_s^T
//   prod_s^T per scale, the (F x C) block of scale s only (for STACKED, the
//   diagonal block of the block-diagonal basis), into a [feature][sample]
//   bf16 tile.
// - MLP on the tensor cores: each layer Z^T = W_l^T A^T with A the previous
//   [unit][sample] tile; bias, ReLU and the bf16 rounding on the fragments;
//   the output layer's f32 fragments go straight to `out` (each store fills
//   whole 32-byte sectors).
// - Residuals (training mode): v is staged per scale in a [row][sample] tile,
//   hsave is the hidden tile itself; after a block barrier the block writes
//   each 64-sample row as eight 16-byte streaming stores, so every sector of
//   vsave and hsave is written whole, once, along N.
// The [row][sample] tiles have 128-byte rows whose 16-byte chunks are
// permuted by (row ^ row >> 3) & 7: the eight rows of an ldmatrix and the
// gather's stores eight rows apart fall in distinct bank quads.
// Measured at N = 262,144 (tools/bwd_bench.py, NVIDIA H100 80GB HBM3, 700 W):
// 0.060 ms eval and 0.14 ms training at the bench shape (the thread-per-sample
// design it replaced: 0.29 / 0.61); the residual write-out is ~0.043 ms of
// the training time, and streaming stores beat plain ones there by ~0.035.
//
// Stacked scales (K13): the same kernel, instantiated with STACKED = true,
// replaces cp_mlp_pallas.py cp_mlp_apply_stacked -> _fwd_impl_stacked ->
// _fwd_kernel_stacked (pallas_call at :531). When every resolution is nested
// in the finest ((R_max - 1) a multiple of every R_s - 1), each coarse line is
// upsampled exactly onto the fine grid (ops/cp_stacked.py) and all scales'
// components sit side by side in one (3, R_max, S*C) bf16 table. A sample then
// has one tent per axis at R_max for all scales and reads scale s's C
// components from columns s*C .. s*C+C-1 of its two rows per axis. The TPU
// projects through the (E, S*C) block-diagonal basis; here output block s
// sums only its own C components (the (S, C, F) diagonal blocks), skipping
// exact zeros. The residual vsave keeps the (3, S*C, N) layout of K1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (explicit
// fmaf only, so elementwise rounding follows the plain PyTorch version).

#include "cp_common.cuh"
#include "mma_common.cuh"

namespace insr {

constexpr int kMaxScales = 4;

// Per scale: the first row's component 0 and the resolution. Per-scale tables
// are (3, R_s, C) bf16; STACKED tables are one (3, R_max, S*C) bf16 table with
// ptr[s] at its column s*C and res[s] = R_max.
struct LineTables {
  const __nv_bfloat16* ptr[kMaxScales];
  int res[kMaxScales];
};

template <int C, int F, int S, int W, int NH, int D>
struct CpFwd {
  static constexpr int E = S * F;
  static constexpr int ROWS = E + NH * W;  // rows of the packed weights
  static constexpr int LDW = W + 8;        // their row stride in shared memory
  static constexpr int LDB = 24;           // basis row stride (F padded to 16, + 8)
  static constexpr int LDP = C + 8;        // prod row stride, [sample][component]
  static constexpr int SPW = kT / kWarps;  // samples per warp (its mma n-tile)
  static constexpr int LPS = C / 8;        // gather lanes per sample (16 bytes each)
  static constexpr int SPI = 32 / LPS;     // samples per warp and gather step
  static constexpr int STEPS = (SPW + SPI - 1) / SPI;
  static constexpr int GROUP = STEPS < 2 ? STEPS : 2;  // gather steps with loads in flight
  // shared memory, in bf16 elements
  static constexpr int WT = ROWS * LDW;
  static constexpr int BS = S * C * LDB;
  static constexpr int PR = kT * LDP;
  static constexpr int X0 = E * kT;
  static constexpr int HB = NH * W * kT;
  static constexpr int VS = 3 * C * kT;  // one scale's v, training mode only
  static constexpr size_t BYTES_EVAL = 2 * (WT + BS + PR + X0 + HB);
  static constexpr size_t BYTES_TRAIN = BYTES_EVAL + 2 * VS;
  static_assert(C % 16 == 0 && 32 % LPS == 0 && F % 8 == 0 && F <= 16 && E % 16 == 0 &&
                    W % 16 == 0 && D % 16 == 0 && D <= W && NH >= 1 && STEPS % GROUP == 0,
                "layout");
};

template <int C, int F, int S, int W, int NH, int D, bool STACKED, bool TRAIN>
__global__ void __launch_bounds__(kThreads, 2)
    cp_mlp_fwd_kernel(const float* __restrict__ x, long long n, LineTables lines,
                      const __nv_bfloat16* __restrict__ basis,
                      const __nv_bfloat16* __restrict__ ws, const float* __restrict__ bs,
                      float* __restrict__ out, __nv_bfloat16* __restrict__ vsave,
                      __nv_bfloat16* __restrict__ hsave) {
  using K = CpFwd<C, F, S, W, NH, D>;
  constexpr int LD = STACKED ? S * C : C;  // row stride of a line table
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* bsm = wt + K::WT;  // [s*C + c][f], f padded to 16 with zeros
  __nv_bfloat16* pr = bsm + K::BS;  // bf16(prod) of one scale, [sample][component]
  __nv_bfloat16* x0 = pr + K::PR;   // bf16(enc), swizzled [feature][sample]
  __nv_bfloat16* hb = x0 + K::X0;   // hidden activations, swizzled [l*W + unit][sample]
  __nv_bfloat16* vs = hb + K::HB;   // v of one scale, swizzled [a*C + c][sample]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_in = lane >> 2, c_in = (lane & 3) * 2;
  const int g = lane / K::LPS, j = lane % K::LPS;  // gather: sample slot, 16-byte chunk
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  load_weights<W>(wt, ws, K::ROWS);
  for (int q = threadIdx.x; q < K::BS; q += kThreads) {
    const int row = q / K::LDB, col = q % K::LDB;
    bsm[q] = col < F ? basis[row * F + col] : zero;
  }
  __syncthreads();

  const long long ntiles = (n + kT - 1) / kT;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long s0 = tile * kT;
    const int nv = static_cast<int>(n - s0 < kT ? n - s0 : kT);
    // this lane's gather samples: tile-local t = 8 warp + step SPI + g
    float u[K::STEPS][3];
    bool mine[K::STEPS];  // the slot lies in this warp's eight samples
#pragma unroll
    for (int st = 0; st < K::STEPS; ++st) {
      const int slot = st * K::SPI + g;
      const int t = warp * K::SPW + slot;
      mine[st] = slot < K::SPW;
      const bool live = mine[st] && t < nv;
#pragma unroll
      for (int a = 0; a < 3; ++a) u[st][a] = live ? x[3 * (s0 + t) + a] : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = lines.res[s];
      __syncwarp();  // this warp's reads of pr (the previous projection) are done
#pragma unroll
      for (int st0 = 0; st0 < K::STEPS; st0 += K::GROUP) {
        uint4 q0[K::GROUP][3], q1[K::GROUP][3];
        float w0[K::GROUP][3], w1[K::GROUP][3];
#pragma unroll
        for (int gi = 0; gi < K::GROUP; ++gi) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const Tent tt = tent(u[st0 + gi][a], r);
            w0[gi][a] = tt.w0;
            w1[gi][a] = tt.w1;
            const __nv_bfloat16* row =
                lines.ptr[s] + (static_cast<long long>(a) * r + tt.i0) * LD;
            q0[gi][a] = __ldg(reinterpret_cast<const uint4*>(row) + j);
            q1[gi][a] = __ldg(reinterpret_cast<const uint4*>(row + LD) + j);
          }
        }
#pragma unroll
        for (int gi = 0; gi < K::GROUP; ++gi) {
          const int st = st0 + gi;
          const int t = warp * K::SPW + st * K::SPI + g;
          uint32_t pk[4];
#pragma unroll
          for (int k2 = 0; k2 < 4; ++k2) {
            float p[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k = 2 * k2 + h;
              float v[3];
#pragma unroll
              for (int a = 0; a < 3; ++a) {
                v[a] = fmaf(w1[gi][a], bf16_at(q1[gi][a], k), w0[gi][a] * bf16_at(q0[gi][a], k));
              }
              if (TRAIN && mine[st]) {
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                  vs[swz(a * C + 8 * j + k, t)] = __float2bfloat16_rn(v[a]);
                }
              }
              p[h] = (v[0] * v[1]) * v[2];
            }
            pk[k2] = pack_bf16x2(p[0], p[1]);
          }
          if (mine[st]) {
            *reinterpret_cast<uint4*>(pr + t * K::LDP + 8 * j) =
                make_uint4(pk[0], pk[1], pk[2], pk[3]);
          }
        }
      }
      __syncwarp();  // the warp's prod rows are staged
      // enc_s^T = B_s^T bf16(prod_s)^T for this warp's 8 samples
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 16) {
        uint32_t af[4], bf[2];
        load_a_t(af, bsm + s * C * K::LDB, K::LDB, k0, 0, lane);
        load_b(bf, pr, K::LDP, warp * K::SPW, k0, lane);
        mma_bf16(acc, af, bf);
      }
      const int tc = warp * K::SPW + c_in;
      if (r_in < F) {
        *reinterpret_cast<uint32_t*>(x0 + swz(s * F + r_in, tc)) = pack_bf16x2(acc[0], acc[1]);
      }
      if (r_in + 8 < F) {
        *reinterpret_cast<uint32_t*>(x0 + swz(s * F + r_in + 8, tc)) =
            pack_bf16x2(acc[2], acc[3]);
      }
      if constexpr (TRAIN) {
        __syncthreads();  // every warp's v of scale s is staged
        store_tile_rows(vs, vsave, n, s0, nv, 3 * C,
                        [s](int row) { return ((row / C) * S + s) * C + row % C; });
        __syncthreads();  // the stage may take the next scale
      }
    }
    __syncwarp();  // this warp's enc columns are staged
    const int tc = warp * K::SPW + c_in;
    // hidden layers: H_l^T = W_l^T A^T, bias, ReLU, bf16 into rows l*W of hb
    // (the swizzle is by the row of the whole tile: layer l's input rows are
    // rows ain0 + k of `ain`)
    static_for<0, NH>([&](auto lc) {
      constexpr int l = decltype(lc)::value;
      constexpr int DIN = l == 0 ? K::E : W;
      constexpr int ROW0 = l == 0 ? 0 : K::E + (l - 1) * W;
      const __nv_bfloat16* ain = l == 0 ? x0 : hb;
      constexpr int ain0 = l == 0 ? 0 : (l - 1) * W;
      float z[W / 16][4];
#pragma unroll
      for (int mt = 0; mt < W / 16; ++mt) z[mt][0] = z[mt][1] = z[mt][2] = z[mt][3] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < DIN; k0 += 16) {
        uint32_t bf[2];
        load_b_swz(bf, ain, ain0 + k0, warp * K::SPW, lane);
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
    // output layer: f32, straight to out (row-major (N, D))
    {
      constexpr int ROW0 = K::E + (NH - 1) * W;
      float o[D / 16][4];
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.0f;
#pragma unroll
      for (int k0 = 0; k0 < W; k0 += 16) {
        uint32_t bf[2];
        load_b_swz(bf, hb, (NH - 1) * W + k0, warp * K::SPW, lane);
#pragma unroll
        for (int mt = 0; mt < D / 16; ++mt) {
          uint32_t af[4];
          load_a_t(af, wt + ROW0 * K::LDW, K::LDW, k0, mt * 16, lane);
          mma_bf16(o[mt], af, bf);
        }
      }
#pragma unroll
      for (int mt = 0; mt < D / 16; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int d = mt * 16 + r_in + 8 * half;
          const float b = __ldg(bs + NH * W + d);
          if (tc < nv) out[(s0 + tc) * D + d] = o[mt][2 * half] + b;
          if (tc + 1 < nv) out[(s0 + tc + 1) * D + d] = o[mt][2 * half + 1] + b;
        }
      }
    }
    if constexpr (TRAIN) {
      __syncthreads();  // every warp's hidden columns are staged
      store_tile_rows(hb, hsave, n, s0, nv, NH * W, [](int row) { return row; });
      // the next tile's hidden rows are written only after its first barrier
    }
  }
}

template <int C, int F, int S, int W, int NH, int D, bool STACKED>
int launch_cp(const float* x, long long n, const LineTables& lines, const void* basis,
              const void* ws, const float* bs, float* out, void* vsave, void* hsave, int* info,
              cudaStream_t stream) {
  using K = CpFwd<C, F, S, W, NH, D>;
  const bool train = vsave != nullptr;
  auto kernel = train ? cp_mlp_fwd_kernel<C, F, S, W, NH, D, STACKED, true>
                      : cp_mlp_fwd_kernel<C, F, S, W, NH, D, STACKED, false>;
  const size_t smem = train ? K::BYTES_TRAIN : K::BYTES_EVAL;
  int plan[3];
  int* p = info != nullptr ? info : plan;
  const int rc = plan_persistent(reinterpret_cast<const void*>(kernel), smem, n, p);
  if (rc != 0) return rc;
  if (n > 0) {
    kernel<<<p[0], kThreads, smem, stream>>>(
        x, n, lines, static_cast<const __nv_bfloat16*>(basis),
        static_cast<const __nv_bfloat16*>(ws), bs, out, static_cast<__nv_bfloat16*>(vsave),
        static_cast<__nv_bfloat16*>(hsave));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape (the Python wrapper lists the supported ones). vsave and
// hsave are both nullptr (eval) or both the residual buffers (training).
// info (nullptr or 3 ints) receives the launch plan: grid, blocks per SM and
// shared-memory bytes per block.
extern "C" int cp_mlp_fwd(const float* x, long long n, const void* const* line_ptrs,
                          const int* res, int n_scales, const void* basis,
                          const void* ws, const float* bs, float* out, int c,
                          int f, int w, int n_hidden, int d, void* vsave,
                          void* hsave, int* info, void* stream) {
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
                                                           bs, out, vsave, hsave, info, st);
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
                                  int n_hidden, int d, void* vsave, void* hsave, int* info,
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
                                                          bs, out, vsave, hsave, info, st);
  INSR_CPS_CASE(64, 16, 2, 64, 1, 16)  // the bench NeRF density head, cp_stacked
  INSR_CPS_CASE(16, 8, 2, 32, 1, 16)   // the small test model
  INSR_CPS_CASE(16, 8, 2, 32, 2, 16)
#undef INSR_CPS_CASE
  return -1;
}
