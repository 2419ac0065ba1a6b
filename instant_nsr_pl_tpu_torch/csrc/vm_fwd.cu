// VM1: the Vector-Matrix encoding forward.
//
// Replaces: instant_nsr_pl_tpu/ops/vm.py vm_encode (:136; vm_encode_fast's
// forward, :166), which is XLA, not Pallas: per scale and plane it builds
// (4, N) plane rows and (2, N) line rows with their weights, gathers the
// (T, N, C) rows with jnp.take and sums them weighted. Here a thread takes one
// sample and one plane j = 3 s + k: it computes the plane's 4 bilinear taps
// and its line's 2 linear taps (vm_common.cuh), reads each tap's C-float row
// as float4 vectors (a 64-byte row at C = 16), sums the taps in order with
// each product rounded (the plain version ops/vm.py _gather_weighted, built
// with --fmad=false: the output equals it to the bit) and writes P * L as
// float4 stores into its slice of the (N, S * 3 * C) output.
//
// Block: 32 consecutive samples x J = 3 S planes (warp j on plane j), so a
// warp's rows come from one plane and one line table and its 32 stores of C
// floats fill whole 32-byte sectors.
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

template <int C>
__global__ void vm_fwd_kernel(const float* __restrict__ x, long long n, VMTables tables,
                              int J, int line_res, float* __restrict__ out) {
  const int j = threadIdx.x >> 5;
  const long long i = static_cast<long long>(blockIdx.x) * 32 + (threadIdx.x & 31);
  if (i >= n) return;
  const float xs[3] = {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
  const VMTaps t = vm_taps(xs, j % 3, tables.plane_res[j], line_res);
  const float* plane = tables.plane[j];
  const float* line = tables.line[j];
  float* dst = out + i * J * C + j * C;
#pragma unroll
  for (int q = 0; q < C; q += 4) {
    float4 prow[4], lrow[2], pf, lf;
    vm_features(plane, line, t, C, q, prow, lrow, pf, lf);
    *reinterpret_cast<float4*>(dst + q) = mul4(pf, lf);
  }
}

template <int C>
int launch_vm_fwd(const float* x, long long n, const VMTables& tables, int J, int line_res,
                  float* out, cudaStream_t stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + 31) / 32);
    vm_fwd_kernel<C><<<blocks, 32 * J, 0, stream>>>(x, n, tables, J, line_res, out);
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
