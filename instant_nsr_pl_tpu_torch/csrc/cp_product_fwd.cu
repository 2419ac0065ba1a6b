// CP line product forward (K5): prod (C, N) = v_x * v_y * v_z.
//
// Replaces: instant_nsr_pl_tpu/ops/cp_pallas.py cp_product ->
// _cp_product_fwd_impl -> _fwd_kernel (pallas_call at :242). The unfused CP
// encode of ops/cp.py impl="fast": the NeuS occupancy update, the level grid
// and the finite-difference SDF run it once per scale (a finite-difference
// step at N and at 6N, the stencil); the basis projection follows on the host.
// Eval launches write only `prod`; training launches also write the TPU
// kernel's residual vsave (3, C, N) bf16, the interpolated line values that
// the backward (K6, csrc/cp_jac_basis_bwd.cu) reads.
//
// What it computes, per sample u (3, N) and axis a, with the tent
// coordinates of cp_common.cuh on the (3, R, C) bf16 line stack L:
//   v_a[c] = w0 * L_a[i0][c] + w1 * L_a[i0 + 1][c]      (f32, one rounding)
//   prod[c] = (v_x[c] * v_y[c]) * v_z[c]
// which equals the TPU kernel's dense (C, R) x (R, BN) tent matmul to the
// bit: the tent column has two non-zeros, both products are exact in f32.
// There is no sum, so prod and vsave equal the plain version to the bit.
//
// What bounds it on an H100: HBM writes. The function reads u (12 B) and
// writes prod (4 B x C) per sample, 268 B at C = 64, and in training mode
// vsave (6 B x C) more, 652 B: 21 us and 51 us at 3.35 TB/s for 262,144
// samples. The tables (48 KB at R = 128, 768 KB at R = 2048) stay in the
// 50 MB L2; each sample reads 2 x 3 of their rows (768 B at C = 64).
//
// Design: K1's tiles (csrc/cp_mlp_fwd.cu) without the projection and the
// MLP. Persistent blocks of 8 warps (mma_common.cuh plan_persistent) walk
// tiles of 64 samples; warp w gathers the tile's samples 8w .. 8w+7.
// - Gather: CG/8 lanes read one row's CG components together (16 bytes each;
//   CG = min(C, 64), so a warp instruction loads whole 128-byte rows), the
//   rows of two gather steps' samples in flight at once (one at C = 128);
//   each lane interpolates its 8 components with the arithmetic above
//   (--fmad=false, explicit fmaf) and stores prod and, in training mode,
//   bf16(v) into [row][sample] tiles in shared memory.
// - Write-out: after a block barrier the block writes each 64-sample row of
//   prod (256 B) and vsave (128 B) as 16-byte streaming stores, so every
//   sector of both is written whole, once, along N; a second barrier frees
//   the tiles for the next pass. Staging the whole block's tile (and not each
//   warp's 8 samples, which would need no barrier) is what makes vsave's
//   rows whole: a warp's 8 samples are 16 bytes of a bf16 row, half a sector.
//   When N is not a multiple of 4 (prod) or 8 (vsave) the row starts c * N
//   are not 16-byte aligned and the rows go out as 4- or 2-byte stores, as
//   K1's residual write-out does.
// - C = 128 (cp_big) runs as two passes of 64 components over the same tile
//   (the same tents), so the staging stays 16 KB + 24 KB at every C.
// The f32 tile has 256-byte rows whose sixteen 16-byte chunks are permuted
// by (row >> 3) & 7 within each half: the gather's stores of eight rows
// eight apart, and the write-out's reads of a row's chunks, fall in distinct
// bank quads. The bf16 tile is mma_common.cuh's swz layout.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false (explicit
// fmaf only, so each rounding follows the plain PyTorch version).

#include "cp_common.cuh"
#include "mma_common.cuh"

namespace insr {

template <int C>
struct ProdFwd {
  static constexpr int CG = C < 64 ? C : 64;  // components of one pass
  static constexpr int PASSES = C / CG;
  static constexpr int SPW = kT / kWarps;      // samples a warp gathers
  static constexpr int LPS = CG / 8;           // gather lanes per sample (16 bytes each)
  static constexpr int SPI = 32 / LPS;         // samples per warp and gather step
  static constexpr int STEPS = (SPW + SPI - 1) / SPI;
  // gather steps with loads in flight: two, but one at C = 128, where the
  // second pass's registers would spill them (and one step is faster there)
  static constexpr int INFLIGHT = STEPS < 2 || PASSES > 1 ? 1 : 2;
  static constexpr int PT = CG * kT;      // f32 prod tile, [component][sample]
  static constexpr int VS = 3 * CG * kT;  // bf16 v tile, [a*CG + component][sample]
  static constexpr size_t BYTES_EVAL = 4 * PT;
  static constexpr size_t BYTES_TRAIN = BYTES_EVAL + 2 * VS;
  static_assert(C % CG == 0 && CG % 8 == 0 && 32 % LPS == 0 && STEPS % INFLIGHT == 0,
                "layout");
};

// Element (row, t) of a [row][sample] f32 tile of kT = 64 samples.
__device__ __forceinline__ int swz_f32(int row, int t) {
  return row * kT + ((((t >> 2) ^ (row >> 3)) & 7) | ((t >> 2) & 8)) * 4 + (t & 3);
}

// Write `rows` rows of a swizzled f32 tile to rows row_of(r) of a (rows, n)
// f32 array, samples [s0, s0 + nv): 16-byte streaming stores when n is a
// multiple of 4 (then every chunk is aligned and nv is a multiple of 4), else
// 4-byte stores. Block-cooperative.
template <typename RowOf>
__device__ __forceinline__ void store_tile_rows_f32(const float* tile, float* __restrict__ dst,
                                                    long long n, long long s0, int nv, int rows,
                                                    RowOf row_of) {
  if ((n & 3) == 0) {
    for (int q = threadIdx.x; q < rows * (kT / 4); q += kThreads) {
      const int r = q / (kT / 4), ch = q % (kT / 4);
      if (ch * 4 < nv) {
        const float4 v = *reinterpret_cast<const float4*>(tile + swz_f32(r, ch * 4));
        __stcs(reinterpret_cast<float4*>(dst + static_cast<long long>(row_of(r)) * n + s0 +
                                         ch * 4),
               v);
      }
    }
  } else {
    for (int q = threadIdx.x; q < rows * kT; q += kThreads) {
      const int r = q / kT, t = q % kT;
      if (t < nv) dst[static_cast<long long>(row_of(r)) * n + s0 + t] = tile[swz_f32(r, t)];
    }
  }
}

template <int C, bool TRAIN>
__global__ void __launch_bounds__(kThreads, 2)
    cp_product_fwd_kernel(const float* __restrict__ u3, long long n,
                          const __nv_bfloat16* __restrict__ lines, int r,
                          float* __restrict__ prod, __nv_bfloat16* __restrict__ vsave) {
  using K = ProdFwd<C>;
  extern __shared__ uint4 smem_u4[];
  float* pt = reinterpret_cast<float*>(smem_u4);                     // prod of one pass
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(pt + K::PT);  // v of one pass
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / K::LPS, j = lane % K::LPS;  // gather: sample slot, 16-byte chunk

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
    for (int p = 0; p < K::PASSES; ++p) {
      const int c0 = p * K::CG;  // the pass's first component
#pragma unroll
      for (int st0 = 0; st0 < K::STEPS; st0 += K::INFLIGHT) {
        uint4 q0[K::INFLIGHT][3], q1[K::INFLIGHT][3];
        float w0[K::INFLIGHT][3], w1[K::INFLIGHT][3];
#pragma unroll
        for (int gi = 0; gi < K::INFLIGHT; ++gi) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const Tent tt = tent(u[st0 + gi][a], r);
            w0[gi][a] = tt.w0;
            w1[gi][a] = tt.w1;
            const __nv_bfloat16* row = lines + (static_cast<long long>(a) * r + tt.i0) * C + c0;
            q0[gi][a] = __ldg(reinterpret_cast<const uint4*>(row) + j);
            q1[gi][a] = __ldg(reinterpret_cast<const uint4*>(row + C) + j);
          }
        }
#pragma unroll
        for (int gi = 0; gi < K::INFLIGHT; ++gi) {
          const int st = st0 + gi;
          if (!mine[st]) continue;
          const int t = warp * K::SPW + st * K::SPI + g;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int c = 8 * j + k;
            float v[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              v[a] = fmaf(w1[gi][a], bf16_at(q1[gi][a], k), w0[gi][a] * bf16_at(q0[gi][a], k));
              if constexpr (TRAIN) vs[swz(a * K::CG + c, t)] = __float2bfloat16_rn(v[a]);
            }
            pt[swz_f32(c, t)] = (v[0] * v[1]) * v[2];
          }
        }
      }
      __syncthreads();  // every warp's rows of the pass are staged
      store_tile_rows_f32(pt, prod, n, s0, nv, K::CG, [c0](int row) { return c0 + row; });
      if constexpr (TRAIN) {
        store_tile_rows(vs, vsave, n, s0, nv, 3 * K::CG,
                        [c0](int row) { return (row / K::CG) * C + c0 + row % K::CG; });
      }
      __syncthreads();  // the tiles may take the next pass
    }
  }
}

template <int C>
int launch_product(const float* u3, long long n, const void* lines, int r, float* prod,
                   void* vsave, int* info, cudaStream_t stream) {
  using K = ProdFwd<C>;
  const bool train = vsave != nullptr;
  auto kernel = train ? cp_product_fwd_kernel<C, true> : cp_product_fwd_kernel<C, false>;
  const size_t smem = train ? K::BYTES_TRAIN : K::BYTES_EVAL;
  int plan[3];
  int* p = info != nullptr ? info : plan;
  const int rc = plan_persistent(reinterpret_cast<const void*>(kernel), smem, n, p);
  if (rc != 0) return rc;
  if (n > 0) {
    kernel<<<p[0], kThreads, smem, stream>>>(u3, n, static_cast<const __nv_bfloat16*>(lines),
                                             r, prod, static_cast<__nv_bfloat16*>(vsave));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches the shape (the Python wrapper lists the supported ones). vsave is
// nullptr (eval) or the (3, C, N) bf16 residual (training). info (nullptr or
// 3 ints) receives the launch plan: grid, blocks per SM and shared-memory
// bytes per block. N = 0 launches nothing.
extern "C" int cp_product_fwd(const float* u3, long long n, const void* lines, int r, int c,
                              float* prod, void* vsave, int* info, void* stream) {
  if (r < 2) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c == 128) return insr::launch_product<128>(u3, n, lines, r, prod, vsave, info, st);  // cp_big
  if (c == 64) return insr::launch_product<64>(u3, n, lines, r, prod, vsave, info, st);  // bench
  if (c == 16) return insr::launch_product<16>(u3, n, lines, r, prod, vsave, info, st);  // tests
  return -1;
}
