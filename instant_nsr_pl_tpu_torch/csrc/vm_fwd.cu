// VM1: the Vector-Matrix encoding forward.
//
// Replaces: instant_nsr_pl_tpu/ops/vm.py vm_encode (:136; vm_encode_fast's
// forward, :166), which is XLA, not Pallas: per scale and plane it builds
// (4, N) plane rows and (2, N) line rows with their weights, gathers the
// (T, N, C) rows with jnp.take and sums them weighted.
//
// Design: a warp takes kVMFwdSamples consecutive samples on one plane j = 3 s
// + k, in passes of 32 / (C / 4) samples: a group of C / 4 lanes holds one
// sample (vm_common.cuh), computes the plane's 4 bilinear taps and its line's
// 2 linear taps, starts the six rows' loads of its float4 (one warp load
// reads whole 64-byte rows at C = 16, 8 rows in 16 sectors), sums the taps in
// order with each product rounded (the plain version ops/vm.py
// _gather_weighted, built with --fmad=false: the output equals it to the bit)
// and stores P * L: each group writes a whole C-float slice, whole sectors.
// Warps run sample tile first and plane second, so the card works on all
// planes at once; a warp's consecutive (ray-ordered) samples share rows, so
// its later passes read them from L1.
//
// What bounds it on an H100: the compulsory bytes are x (12 B) and the
// output (S * 3 * C * 4 = 384 B at the VM NeRF's width) per sample plus each
// table row the samples touch, read once (about 64 MB of tables at plane 512,
// line 2048, 2 scales, C = 16): 0.05 ms for 262,144 uniform samples at 3.35
// TB/s. The row reads are 36 x 64 B per sample, scattered: 604 MB of sectors
// at N = 262,144, most of them L2 hits when the tables' working set fits the
// 50 MB L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include "vm_common.cuh"

namespace insr {

// Consecutive samples a warp takes on its plane.
constexpr int kVMFwdSamples = 32;

template <int C>
__global__ void __launch_bounds__(kVMBlock)
    vm_fwd_kernel(const float* __restrict__ x, long long n, VMTables tables, int J, int line_res,
                  float* __restrict__ out) {
  constexpr int L = VMLanes<C>::kLanes, G = VMLanes<C>::kGroups;
  const long long task = static_cast<long long>(blockIdx.x) * (kVMBlock / 32) + (threadIdx.x >> 5);
  const long long first = task / J * kVMFwdSamples;
  const int j = static_cast<int>(task % J);
  if (first >= n) return;
  const int lane = threadIdx.x & 31;
  const int g = lane / L, q = (lane % L) * 4;
  const int res = tables.plane_res[j];
  const float* plane = tables.plane[j];
  const float* line = tables.line[j];
  // two passes' loads in flight; past the end a group reads the last sample
  // and stores nothing
#pragma unroll 2
  for (int p = 0; p < kVMFwdSamples / G; ++p) {
    const long long i = first + p * G + g;
    const long long ii = i < n ? i : n - 1;
    const float xs[3] = {x[3 * ii], x[3 * ii + 1], x[3 * ii + 2]};
    const VMTaps t = vm_taps(xs, j % 3, res, line_res);
    float4 prow[4], lrow[2], pf, lf;
    vm_rows(plane, line, t, C, q, prow, lrow);
    vm_features(t, prow, lrow, pf, lf);
    if (i < n) *reinterpret_cast<float4*>(out + i * J * C + j * C + q) = mul4(pf, lf);
  }
}

template <int C>
int launch_vm_fwd(const float* x, long long n, const VMTables& tables, int J, int line_res,
                  float* out, cudaStream_t stream) {
  if (n > 0) {
    const long long tasks = (n + kVMFwdSamples - 1) / kVMFwdSamples * J;
    const unsigned blocks = static_cast<unsigned>((tasks + kVMBlock / 32 - 1) / (kVMBlock / 32));
    vm_fwd_kernel<C><<<blocks, kVMBlock, 0, stream>>>(x, n, tables, J, line_res, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace insr

// Returns cudaGetLastError() after the launch, or -1 when no instantiation
// matches (C not in {4, 8, 16, 32}, or J not a multiple of 3 in [3, 12]).
// x (n, 3) float32; `tables` holds J planes and lines (vm_common.cuh
// VMTables); out (n, J * C) float32.
extern "C" int vm_fwd(const float* x, long long n, const insr::VMTables* tables, int J, int c,
                      int line_res, float* out, void* stream) {
  if (J < 3 || J > insr::kVMMaxJ || J % 3 != 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 4: return insr::launch_vm_fwd<4>(x, n, *tables, J, line_res, out, st);
    case 8: return insr::launch_vm_fwd<8>(x, n, *tables, J, line_res, out, st);
    case 16: return insr::launch_vm_fwd<16>(x, n, *tables, J, line_res, out, st);
    case 32: return insr::launch_vm_fwd<32>(x, n, *tables, J, line_res, out, st);
    default: return -1;
  }
}
