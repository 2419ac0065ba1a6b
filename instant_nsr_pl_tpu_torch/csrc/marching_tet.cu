// MT1 / MT2: marching tetrahedra on the card, the port's counterpart of the
// JAX package's native pass.
//
// Replaces: instant_nsr_pl_tpu/ops/native/marching_tet.cc (mt_run, a serial
// C++ loop over cubes with a hash map for the weld) and its numpy twin
// instant_nsr_pl_tpu/ops/isosurface.py marching_tetrahedra (:95), whose
// output this pass reproduces: the same vertices in the same order (the
// unique undirected grid-edge keys lo * R^3 + hi in ascending order, drawn
// from every emitted face) and the same faces in the same order (cube order,
// x-major; then tetrahedron order; then triangle order), with the same
// float32 arithmetic:
// - each cube is split into 6 tetrahedra around its main diagonal; a cube is
//   active when the minimum of its 8 values is below iso and the maximum at
//   or above it (a NaN corner makes it inactive, as numpy's min / max do);
// - a tetrahedron's 4-bit mask marks its corners below iso; the 16-case
//   table (1 or 3 inside: one triangle, 2 inside: a quad as two) is built
//   from the same rules as the twin's _build_tet_table, at compile time;
// - a vertex on edge (lo, hi) is pa + t (pb - pa) with t = (iso - v_lo) /
//   (v_hi - v_lo) (0.5 where |v_hi - v_lo| <= 1e-12), clipped to [0, 1];
// - a face whose three keys are not distinct is dropped (after the weld:
//   its edges still give vertices);
// - orientation: the centroid ((a + b) + c) / 3, rounded half to even
//   (rintf, np.round) and clipped to [1, R - 2] per axis, picks the central
//   difference of the field; the face flips to (c, b, a) when the cross
//   product of its edges, np.cross's products and differences, dotted with
//   that gradient in order is below 0.
// Built with --fmad=false, so no product and sum are contracted: the
// vertices equal the twin's to the bit.
//
// Passes (ops/isosurface.py marching_tetrahedra_launch):
//   MT1 mt_classify: one thread per cube writes its triangle count (0-12) as
//       one byte: 133 MB for the 511^3 cubes of a 512^3 grid;
//   (torch) nonzero of the counts: the active cubes in cube order, and the
//       exclusive cumsum of their counts: each cube's first face;
//   MT2 mt_emit: one thread per active cube writes its faces' edge keys
//       (int64: R^6 reaches 1.8e16 at 512^3), already in their final
//       orientation, and a flag per degenerate face;
//   (torch) unique of the keys, sorted, with the inverse: the faces;
//   MT2 mt_verts: one thread per unique key interpolates its vertex.
//
// What bounds it on an H100: MT1 reads the grid (537 MB at 512^3) and writes
// the counts (133 MB): 0.2 ms at 3.35 TB/s; MT2 reads the active cubes'
// corners and writes 24 bytes of keys per face.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a --fmad=false.

#include <cstdint>

#include <cuda_runtime.h>

namespace insr {

// the 8 cube corners in (x, y, z) bit order: corner i is ((i>>0)&1, (i>>1)&1, (i>>2)&1)
// 6 tetrahedra, all on the main diagonal corner 0 -> corner 7
__constant__ int kTets[6][4] = {{0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
                                {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7}};
// a tetrahedron's 6 edges (local a, local b), a < b
__constant__ int kTetEdges[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

struct TetTable {
  int tris[16][2][3];  // tet-edge ids, -1 padded
  int count[16];
};

constexpr int edge_of_pair(int a, int b) {
  constexpr int e[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
  for (int i = 0; i < 6; ++i)
    if ((e[i][0] == a && e[i][1] == b) || (e[i][0] == b && e[i][1] == a)) return i;
  return -1;
}

// the 16-case table, by the rules of ops/isosurface.py _build_tet_table
constexpr TetTable make_table() {
  TetTable t{};
  for (int m = 0; m < 16; ++m) {
    t.count[m] = 0;
    for (int k = 0; k < 2; ++k)
      for (int j = 0; j < 3; ++j) t.tris[m][k][j] = -1;
  }
  for (int mask = 1; mask < 15; ++mask) {
    int in[4] = {0, 0, 0, 0}, out[4] = {0, 0, 0, 0}, ni = 0, no = 0;
    for (int v = 0; v < 4; ++v) {
      if ((mask >> v) & 1) in[ni++] = v;
      else out[no++] = v;
    }
    if (ni == 1) {
      for (int j = 0; j < 3; ++j) t.tris[mask][0][j] = edge_of_pair(in[0], out[j]);
      t.count[mask] = 1;
    } else if (ni == 3) {
      for (int j = 0; j < 3; ++j) t.tris[mask][0][j] = edge_of_pair(out[0], in[j]);
      t.count[mask] = 1;
    } else {
      const int q[4] = {edge_of_pair(in[0], out[0]), edge_of_pair(in[0], out[1]),
                        edge_of_pair(in[1], out[1]), edge_of_pair(in[1], out[0])};
      t.tris[mask][0][0] = q[0];
      t.tris[mask][0][1] = q[1];
      t.tris[mask][0][2] = q[2];
      t.tris[mask][1][0] = q[0];
      t.tris[mask][1][1] = q[2];
      t.tris[mask][1][2] = q[3];
      t.count[mask] = 2;
    }
  }
  return t;
}

__constant__ TetTable kTable = make_table();

struct Grid {
  const float* v;
  long long rx, ry, rz;
  long long nx, ny, nz;  // cubes per axis
  float iso;
};

__device__ __forceinline__ long long cube_origin(const Grid& g, long long cube) {
  const long long oz = cube % g.nz;
  const long long oy = (cube / g.nz) % g.ny;
  const long long ox = cube / (g.nz * g.ny);
  return (ox * g.ry + oy) * g.rz + oz;
}

// The cube's 8 corner ids and values; false when the cube is inactive (the
// min of its values not below iso or the max below it, or a NaN corner)
__device__ __forceinline__ bool load_cube(const Grid& g, long long cube, long long (&vid)[8],
                                          float (&val)[8]) {
  const long long o = cube_origin(g, cube);
  bool nan = false;
  float lo = 0.0f, hi = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    vid[c] = o + (c & 1) * g.ry * g.rz + ((c >> 1) & 1) * g.rz + ((c >> 2) & 1);
    val[c] = g.v[vid[c]];
    nan = nan || val[c] != val[c];
    lo = c == 0 ? val[c] : fminf(lo, val[c]);
    hi = c == 0 ? val[c] : fmaxf(hi, val[c]);
  }
  return !nan && lo < g.iso && hi >= g.iso;
}

__device__ __forceinline__ int tet_mask(const float (&val)[8], int t, float iso) {
  int mask = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) mask |= (val[kTets[t][j]] < iso ? 1 : 0) << j;
  return mask;
}

// vertex id -> grid coordinates (x, y, z) as float32
__device__ __forceinline__ void coords(const Grid& g, long long id, float (&p)[3]) {
  p[0] = static_cast<float>(id / (g.ry * g.rz));
  p[1] = static_cast<float>((id / g.rz) % g.ry);
  p[2] = static_cast<float>(id % g.rz);
}

// the welded vertex of edge key lo * R^3 + hi
__device__ __forceinline__ void edge_vertex(const Grid& g, long long key, float (&out)[3]) {
  const long long total = g.rx * g.ry * g.rz;
  const long long lo = key / total, hi = key % total;
  const float va = g.v[lo], vb = g.v[hi];
  const float denom = vb - va;
  float t = fabsf(denom) > 1e-12f ? (g.iso - va) / denom : 0.5f;
  t = t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
  float pa[3], pb[3];
  coords(g, lo, pa);
  coords(g, hi, pb);
#pragma unroll
  for (int d = 0; d < 3; ++d) out[d] = pa[d] + t * (pb[d] - pa[d]);
}

// np.clip(np.round(c).astype(int64), 1, R - 2), and a numpy index that may be -1
__device__ __forceinline__ long long round_clip(float c, long long r) {
  long long i = static_cast<long long>(rintf(c));
  i = i < 1 ? 1 : i;
  return i > r - 2 ? r - 2 : i;
}

__device__ __forceinline__ long long wrap(long long i, long long r) { return i < 0 ? i + r : i; }

__device__ __forceinline__ float at(const Grid& g, long long x, long long y, long long z) {
  return g.v[(wrap(x, g.rx) * g.ry + wrap(y, g.ry)) * g.rz + wrap(z, g.rz)];
}

// true when the face (k0, k1, k2) must be reversed to face increasing values
__device__ __forceinline__ bool flip_face(const Grid& g, const long long (&k)[3]) {
  float p[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) edge_vertex(g, k[j], p[j]);
  float c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) c[d] = ((p[0][d] + p[1][d]) + p[2][d]) / 3.0f;
  const long long gx = round_clip(c[0], g.rx), gy = round_clip(c[1], g.ry),
                  gz = round_clip(c[2], g.rz);
  const float dgx = at(g, gx + 1, gy, gz) - at(g, gx - 1, gy, gz);
  const float dgy = at(g, gx, gy + 1, gz) - at(g, gx, gy - 1, gz);
  const float dgz = at(g, gx, gy, gz + 1) - at(g, gx, gy, gz - 1);
  float e1[3], e2[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    e1[d] = p[1][d] - p[0][d];
    e2[d] = p[2][d] - p[0][d];
  }
  const float n0 = e1[1] * e2[2] - e1[2] * e2[1];
  const float n1 = e1[2] * e2[0] - e1[0] * e2[2];
  const float n2 = e1[0] * e2[1] - e1[1] * e2[0];
  const float dot = (n0 * dgx + n1 * dgy) + n2 * dgz;
  return dot < 0.0f;
}

__global__ void mt_classify_kernel(Grid g, uint8_t* __restrict__ counts) {
  const long long n_cubes = g.nx * g.ny * g.nz;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long cube = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       cube < n_cubes; cube += stride) {
    long long vid[8];
    float val[8];
    int n = 0;
    if (load_cube(g, cube, vid, val)) {
#pragma unroll
      for (int t = 0; t < 6; ++t) n += kTable.count[tet_mask(val, t, g.iso)];
    }
    counts[cube] = static_cast<uint8_t>(n);
  }
}

__global__ void mt_emit_kernel(Grid g, const int64_t* __restrict__ cubes,
                               const int64_t* __restrict__ first, long long n_active,
                               int64_t* __restrict__ keys, uint8_t* __restrict__ degenerate) {
  const long long a = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (a >= n_active) return;
  long long vid[8];
  float val[8];
  load_cube(g, cubes[a], vid, val);
  const long long total = g.rx * g.ry * g.rz;
  long long f = first[a];
  for (int t = 0; t < 6; ++t) {
    const int mask = tet_mask(val, t, g.iso);
    for (int k = 0; k < kTable.count[mask]; ++k) {
      long long key[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int e = kTable.tris[mask][k][j];
        const long long va = vid[kTets[t][kTetEdges[e][0]]], vb = vid[kTets[t][kTetEdges[e][1]]];
        key[j] = (va < vb ? va : vb) * total + (va < vb ? vb : va);
      }
      const bool degen = key[0] == key[1] || key[1] == key[2] || key[0] == key[2];
      const bool flip = !degen && flip_face(g, key);
      keys[3 * f] = flip ? key[2] : key[0];
      keys[3 * f + 1] = key[1];
      keys[3 * f + 2] = flip ? key[0] : key[2];
      degenerate[f] = degen ? 1 : 0;
      ++f;
    }
  }
}

__global__ void mt_verts_kernel(Grid g, const int64_t* __restrict__ keys, long long n_keys,
                                float* __restrict__ verts) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_keys) return;
  float p[3];
  edge_vertex(g, keys[i], p);
#pragma unroll
  for (int d = 0; d < 3; ++d) verts[3 * i + d] = p[d];
}

constexpr int kMTBlock = 256;

inline Grid make_grid(const float* values, long long rx, long long ry, long long rz, float iso) {
  return Grid{values, rx, ry, rz, rx - 1, ry - 1, rz - 1, iso};
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kMTBlock - 1) / kMTBlock);
}

}  // namespace insr

// MT1. values (rx, ry, rz) float32, indexed (x * ry + y) * rz + z, each axis
// >= 2; counts ((rx - 1) * (ry - 1) * (rz - 1),) uint8, the triangles of
// each cube in cube order. Returns cudaGetLastError() after the launch.
extern "C" int mt_classify(const float* values, long long rx, long long ry, long long rz,
                           float iso, uint8_t* counts, void* stream) {
  const insr::Grid g = insr::make_grid(values, rx, ry, rz, iso);
  const long long n_cubes = g.nx * g.ny * g.nz;
  if (n_cubes > 0) {
    int sms = 132;
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long cap = static_cast<long long>(sms) * 16;  // grid-stride: 16 blocks an SM
    const unsigned blocks = static_cast<unsigned>(
        insr::blocks_for(n_cubes) < cap ? insr::blocks_for(n_cubes) : cap);
    insr::mt_classify_kernel<<<blocks, insr::kMTBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        g, counts);
  }
  return static_cast<int>(cudaGetLastError());
}

// MT2, first launch. cubes (n_active,) int64, the active cubes in cube
// order; first (n_active,) int64, each cube's first face (exclusive cumsum
// of MT1's counts); keys (faces, 3) int64, degenerate (faces,) uint8.
extern "C" int mt_emit(const float* values, long long rx, long long ry, long long rz, float iso,
                       const int64_t* cubes, const int64_t* first, long long n_active,
                       int64_t* keys, uint8_t* degenerate, void* stream) {
  const insr::Grid g = insr::make_grid(values, rx, ry, rz, iso);
  if (n_active > 0)
    insr::mt_emit_kernel<<<insr::blocks_for(n_active), insr::kMTBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(g, cubes, first, n_active, keys,
                                                                degenerate);
  return static_cast<int>(cudaGetLastError());
}

// MT2, second launch. keys (n_keys,) int64, the unique edge keys; verts
// (n_keys, 3) float32 in grid coordinates.
extern "C" int mt_verts(const float* values, long long rx, long long ry, long long rz, float iso,
                        const int64_t* keys, long long n_keys, float* verts, void* stream) {
  const insr::Grid g = insr::make_grid(values, rx, ry, rz, iso);
  if (n_keys > 0)
    insr::mt_verts_kernel<<<insr::blocks_for(n_keys), insr::kMTBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(g, keys, n_keys, verts);
  return static_cast<int>(cudaGetLastError());
}
