// CP product with its analytic Jacobian and the basis projection fused (K9):
// enc (F, N) = B^T (v_x v_y v_z) and jac (3, F, N), jac_a = d enc / d u_a.
//
// Replaces: instant_nsr_pl_tpu/ops/cp_pallas.py cp_product_jac_basis ->
// _cp_jacb_fwd_impl -> _jacb_fwd_kernel (pallas_call at :633), the NeuS
// analytic-gradient hot path (ops/cp.py cp_encode_with_jac): the SDF network's
// encoding and its Jacobian in one pass, so the eikonal loss's second-order
// graph never differentiates through this op (its backward is
// csrc/cp_jac_basis_bwd.cu). Training launches also write the TPU kernel's
// residuals vsave and gdsave (3, C, N) bf16; eval launches (a rendered view,
// under no_grad) write neither.
//
// What it computes, per sample u (3, N), axis a and component c, with the
// tent coordinates of cp_common.cuh on the (3, R, C) bf16 line stack L and
// the (C, F) bf16 basis B:
//   v_a  = w0 * L_a[i0] + w1 * L_a[i0 + 1]            (f32, one rounding)
//   gd_a = L_a[i0 + 1] - L_a[i0]                      (the exact diff-hot product)
//   g_a  = gd_a * s_a,   s_a = (R - 1) * d clip(u_a)/du_a (0.5 at exact 0 or 1)
//   enc[f]    = sum_c B[c][f] * bf16((v_x * v_y) * v_z)
//   jac_x[f]  = sum_c B[c][f] * bf16(g_x * (v_y * v_z)), and so on per axis
// with f32 sums: the TPU kernel's bf16-operand projection matmuls. gd is the
// right-derivative at an interior knot (i0 = floor(p)), as on the TPU. The
// residuals and the four bf16 products equal the plain version's to the bit;
// enc and jac sum in the tensor cores' order.
//
// What bounds it on an H100: HBM. Per sample it reads u (12 B) and writes enc
// and jac (4 x F x 4 B = 256 B at F = 16), and in training mode vsave and gdsave
// (12 B x C = 768 B at C = 64): 268 B and 1,036 B, 21 us and 81 us at 3.35 TB/s
// for 262,144 samples. The projection is 4 x C x F = 4,096 multiply-adds per
// sample, 2 us on the tensor cores.
//
// Design: K1's tiles (csrc/cp_mlp_fwd.cu). Persistent blocks of 8 warps
// (mma_common.cuh plan_persistent) walk tiles of 64 samples; warp w owns the
// tile's samples 8w .. 8w+7 from the gather to enc and jac, so in eval mode a
// tile needs no block barrier.
// - Gather: CG/8 lanes read one row's CG components together (16 bytes each;
//   CG = min(C, 64), so a warp instruction loads whole 128-byte rows), the
//   rows of two gather steps' samples in flight at once (one at C = 128);
//   each lane computes v, gd and g of its 8 components in f32 with the
//   arithmetic above (--fmad=false, explicit fmaf) and stores the four bf16
//   products as one 16-byte row chunk each of four [sample][component]
//   tiles. Every bf16 value is converted two components at a time
//   (cvt.rn.bf16x2.f32).
// - Projection on the tensor cores (mma.sync m16n8k16): [enc | jac_x | jac_y
//   | jac_z]^T = B^T [P | J_x | J_y | J_z]^T for the warp's 8 samples, B^T
//   (F padded to 16 rows with zeros) read from shared memory with ldmatrix
//   per use: kept in registers over the tile it would cost 16-32 registers a
//   thread through the gather, where the loads in flight need them.
// - enc and jac: the f32 output fragments go straight to global memory, each
//   lane two adjacent samples of a row as one 8-byte streaming store, so the
//   four lanes of a row fill one 32-byte sector.
// - Residuals (training mode): v and gd are staged in swizzled [row][sample]
//   tiles (mma_common.cuh swz); after a block barrier the block writes each
//   64-sample row as eight 16-byte streaming stores (store_tile_rows), so
//   every sector of vsave and gdsave is written whole, once, along N.
// - C = 128 (cp_big) runs as two passes of 64 components into the same
//   accumulators, so the four product tiles (36 KB) and the residual staging
//   (48 KB) keep two blocks on an SM at every instantiation.
//
// Stacked scales (K11): the kernel is written for S scales that share one
// (3, R, S*C) bf16 table (row r holds every scale's C components side by
// side) and an (S, C, F) basis, with outputs enc (S*F, N), jac (3, S*F, N) and
// residuals (3, S*C, N). K9 is its S = 1 instantiation, launched once per
// scale. With S = 2 it replaces cp_pallas.py cp_jac_basis_stacked ->
// _cp_jacs_fwd_impl -> _jacs_fwd_kernel (pallas_call at :904): all scales
// upsampled onto the finest grid (ops/cp_stacked.py), one tent per axis at
// R_max, and the TPU's (E, S*C) block-diagonal projection computed as its S
// diagonal blocks: output block s sums components s*C .. s*C+C-1 only. The
// scales run one after the other through the same tiles. Per sample the
// stacked kernel moves 12 B in, 512 B of enc and jac out and, training,
// 1,536 B of residuals (S*C = 128, F = 16).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "cp_common.cuh"
#include "mma_common.cuh"

namespace insr {

template <int C, int F, int S>
struct JacFwd {
  static constexpr int CG = C < 64 ? C : 64;  // components of one pass
  static constexpr int PASSES = C / CG;        // passes per scale
  static constexpr int SPW = kT / kWarps;      // samples per warp (its mma n-tile)
  static constexpr int LPS = CG / 8;           // gather lanes per sample (16 bytes each)
  static constexpr int SPI = 32 / LPS;         // samples per warp and gather step
  static constexpr int STEPS = (SPW + SPI - 1) / SPI;
  // gather steps with loads in flight: two, but one at C = 128, where the
  // second pass's registers would spill them (and one step is faster there)
  static constexpr int INFLIGHT = STEPS < 2 || PASSES > 1 ? 1 : 2;
  static constexpr int LDB = 24;       // basis row stride (F padded to 16, + 8)
  static constexpr int LDP = CG + 8;   // product tile row stride, [sample][component]
  // shared memory, in bf16 elements
  static constexpr int BS = S * C * LDB;
  static constexpr int PT = kT * LDP;  // one product tile
  static constexpr int RT = 3 * CG * kT;  // one residual tile of a pass, training mode only
  static constexpr size_t BYTES_EVAL = 2 * (BS + 4 * PT);
  static constexpr size_t BYTES_TRAIN = BYTES_EVAL + 2 * 2 * RT;
  static_assert(C % CG == 0 && CG % 16 == 0 && 32 % LPS == 0 && F % 8 == 0 && F <= 16 &&
                    STEPS % INFLIGHT == 0,
                "layout");
};

// bf16(a) and bf16(b) into rows `row` and `row + 1` of a swizzled bf16 tile
// at sample t, with one paired conversion (cvt.rn.bf16x2.f32; the same
// rounding as two scalar ones, in one instruction).
__device__ __forceinline__ void stage_pair(__nv_bfloat16* tile, int row, int t, float a, float b) {
  const uint32_t p = pack_bf16x2(a, b);
  unsigned short* h = reinterpret_cast<unsigned short*>(tile);
  h[swz(row, t)] = static_cast<unsigned short>(p & 0xffffu);
  h[swz(row + 1, t)] = static_cast<unsigned short>(p >> 16);
}

template <int C, int F, int S, bool TRAIN>
__global__ void __launch_bounds__(kThreads, 2)
    cp_jac_basis_fwd_kernel(const float* __restrict__ u3, long long n,
                            const __nv_bfloat16* __restrict__ lines, int r,
                            const __nv_bfloat16* __restrict__ basis,
                            float* __restrict__ enc, float* __restrict__ jac,
                            __nv_bfloat16* __restrict__ vsave,
                            __nv_bfloat16* __restrict__ gdsave) {
  using K = JacFwd<C, F, S>;
  constexpr int LD = S * C;  // row stride of the line table
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* bsm = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [s*C + c][f], f padded
  __nv_bfloat16* pr = bsm + K::BS;  // bf16 products P, J_x, J_y, J_z: [sample][component]
  __nv_bfloat16* vs = pr + 4 * K::PT;  // v of one pass, swizzled [a*CG + c][sample]
  __nv_bfloat16* gs = vs + K::RT;      // gd of one pass, the same
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r_in = lane >> 2, c_in = (lane & 3) * 2;
  const int g = lane / K::LPS, j = lane % K::LPS;  // gather: sample slot, 16-byte chunk
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

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
      for (int a = 0; a < 3; ++a) u[st][a] = live ? __ldg(u3 + a * n + s0 + t) : 0.0f;
    }
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      float acc[4][4];  // [enc | jac_x | jac_y | jac_z] fragments of scale s
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
#pragma unroll 1
      for (int p = 0; p < K::PASSES; ++p) {
        const int c0 = s * C + p * K::CG;  // the pass's first (stacked) component
        __syncwarp();  // this warp's reads of pr (the previous projection) are done
#pragma unroll
        for (int st0 = 0; st0 < K::STEPS; st0 += K::INFLIGHT) {
          uint4 q0[K::INFLIGHT][3], q1[K::INFLIGHT][3];
          float w0[K::INFLIGHT][3], w1[K::INFLIGHT][3], sc[K::INFLIGHT][3];
#pragma unroll
          for (int gi = 0; gi < K::INFLIGHT; ++gi) {
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const Tent tt = tent(u[st0 + gi][a], r);
              w0[gi][a] = tt.w0;
              w1[gi][a] = tt.w1;
              sc[gi][a] = tt.s;
              const __nv_bfloat16* row =
                  lines + (static_cast<long long>(a) * r + tt.i0) * LD + c0;
              q0[gi][a] = __ldg(reinterpret_cast<const uint4*>(row) + j);
              q1[gi][a] = __ldg(reinterpret_cast<const uint4*>(row + LD) + j);
            }
          }
#pragma unroll
          for (int gi = 0; gi < K::INFLIGHT; ++gi) {
            const int st = st0 + gi;
            if (!mine[st]) continue;
            const int t = warp * K::SPW + st * K::SPI + g;
            uint32_t pk[4][4];  // the four products' 8 components, packed bf16 pairs
#pragma unroll
            for (int k2 = 0; k2 < 4; ++k2) {  // components 2 k2, 2 k2 + 1
              float pp[4][2], v[2][3], gd[2][3];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int k = 2 * k2 + h;
                float gg[3];
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                  const float lo = bf16_at(q0[gi][a], k), hi = bf16_at(q1[gi][a], k);
                  v[h][a] = fmaf(w1[gi][a], hi, w0[gi][a] * lo);
                  gd[h][a] = hi - lo;
                  gg[a] = gd[h][a] * sc[gi][a];
                }
                pp[0][h] = (v[h][0] * v[h][1]) * v[h][2];
                pp[1][h] = gg[0] * (v[h][1] * v[h][2]);
                pp[2][h] = gg[1] * (v[h][0] * v[h][2]);
                pp[3][h] = gg[2] * (v[h][0] * v[h][1]);
              }
#pragma unroll
              for (int q = 0; q < 4; ++q) pk[q][k2] = pack_bf16x2(pp[q][0], pp[q][1]);
              if constexpr (TRAIN) {
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                  const int row = a * K::CG + 8 * j + 2 * k2;
                  stage_pair(vs, row, t, v[0][a], v[1][a]);
                  stage_pair(gs, row, t, gd[0][a], gd[1][a]);
                }
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              *reinterpret_cast<uint4*>(pr + q * K::PT + t * K::LDP + 8 * j) =
                  make_uint4(pk[q][0], pk[q][1], pk[q][2], pk[q][3]);
            }
          }
        }
        __syncwarp();  // the warp's product rows are staged
        // [enc | jac]^T += B_s^T [P | J]^T over this pass's components, for
        // this warp's 8 samples
#pragma unroll
        for (int k0 = 0; k0 < K::CG; k0 += 16) {
          uint32_t af[4];
          load_a_t(af, bsm + c0 * K::LDB, K::LDB, k0, 0, lane);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t bf[2];
            load_b(bf, pr + q * K::PT, K::LDP, warp * K::SPW, k0, lane);
            mma_bf16(acc[q], af, bf);
          }
        }
        if constexpr (TRAIN) {
          __syncthreads();  // every warp's v and gd of the pass are staged
          const auto row_of = [c0](int row) { return (row / K::CG) * LD + c0 + row % K::CG; };
          store_tile_rows(vs, vsave, n, s0, nv, 3 * K::CG, row_of);
          store_tile_rows(gs, gdsave, n, s0, nv, 3 * K::CG, row_of);
          __syncthreads();  // the stages may take the next pass
        }
      }
      // scale s's rows of enc and jac: rows f = r_in (+ 8), samples tc, tc + 1
      const int tc = warp * K::SPW + c_in;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float* out = q == 0 ? enc : jac + static_cast<long long>(q - 1) * S * F * n;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int f = r_in + 8 * half;
          if (f >= F) continue;
          float* dst = out + static_cast<long long>(s * F + f) * n + s0 + tc;
          const float lo = acc[q][2 * half], hi = acc[q][2 * half + 1];
          if ((n & 1) == 0) {  // dst is 8-byte aligned and nv is even
            if (tc < nv) __stcs(reinterpret_cast<float2*>(dst), make_float2(lo, hi));
          } else {
            if (tc < nv) dst[0] = lo;
            if (tc + 1 < nv) dst[1] = hi;
          }
        }
      }
    }
  }
}

template <int C, int F, int S>
int launch_jac_basis(const float* u3, long long n, const void* lines, int r,
                     const void* basis, float* enc, float* jac, void* vsave, void* gdsave,
                     int* info, cudaStream_t stream) {
  using K = JacFwd<C, F, S>;
  const bool train = vsave != nullptr;
  auto kernel = train ? cp_jac_basis_fwd_kernel<C, F, S, true>
                      : cp_jac_basis_fwd_kernel<C, F, S, false>;
  const size_t smem = train ? K::BYTES_TRAIN : K::BYTES_EVAL;
  int plan[3];
  int* p = info != nullptr ? info : plan;
  const int rc = plan_persistent(reinterpret_cast<const void*>(kernel), smem, n, p);
  if (rc != 0) return rc;
  if (n > 0) {
    kernel<<<p[0], kThreads, smem, stream>>>(
        u3, n, static_cast<const __nv_bfloat16*>(lines), r,
        static_cast<const __nv_bfloat16*>(basis), enc, jac,
        static_cast<__nv_bfloat16*>(vsave), static_cast<__nv_bfloat16*>(gdsave));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape. vsave and gdsave are both nullptr (eval) or both the
// (3, C, N) bf16 residuals (training). info (nullptr or 3 ints) receives the
// launch plan: grid, blocks per SM and shared-memory bytes per block. N = 0
// launches nothing.
extern "C" int cp_jac_basis_fwd(const float* u3, long long n, const void* lines, int r,
                                int c, int f, const void* basis, float* enc, float* jac,
                                void* vsave, void* gdsave, int* info, void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_JACB_CASE(C_, F_)                                                   \
  if (c == C_ && f == F_)                                                        \
    return insr::launch_jac_basis<C_, F_, 1>(u3, n, lines, r, basis, enc, jac, vsave, \
                                             gdsave, info, st);
  INSR_JACB_CASE(128, 16)  // the bench NeuS SDF encoding at bench.py --encoding cp_big
  INSR_JACB_CASE(64, 16)   // the bench NeuS SDF encoding
  INSR_JACB_CASE(16, 8)   // the small test model
#undef INSR_JACB_CASE
  return -1;
}

// K11, the stacked-scales forward: `lines` is the (3, R_max, S*C) bf16 fine
// table, r = R_max, `basis` the (S, C, F) bf16 diagonal blocks; outputs enc
// (S*F, N), jac (3, S*F, N) and, training, the (3, S*C, N) bf16 residuals.
extern "C" int cp_jac_stacked_fwd(const float* u3, long long n, const void* lines, int r,
                                  int c, int f, int n_scales, const void* basis, float* enc,
                                  float* jac, void* vsave, void* gdsave, int* info,
                                  void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INSR_JACS_CASE(C_, F_, S_)                                                  \
  if (c == C_ && f == F_ && n_scales == S_)                                         \
    return insr::launch_jac_basis<C_, F_, S_>(u3, n, lines, r, basis, enc, jac, vsave, \
                                              gdsave, info, st);
  INSR_JACS_CASE(64, 16, 2)  // the bench NeuS SDF encoding, cp_stacked
  INSR_JACS_CASE(16, 8, 2)   // the small test model
#undef INSR_JACS_CASE
  return -1;
}
