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
// - orientation: the centroid ((a + b) + c) / 3, rounded half to even
//   (rintf, np.round) and clipped to [1, R - 2] per axis, picks the central
//   difference of the field; the face flips to (c, b, a) when the cross
//   product of its edges, np.cross's products and differences, dotted with
//   that gradient in order is below 0.
// The twin drops faces whose three keys are not distinct; a face's three
// edges are three distinct edges of one tetrahedron, so of the grid, and
// none is ever dropped: the pass has no such filter.
// Built with --fmad=false, so no product and sum are contracted: the
// vertices equal the twin's to the bit.
//
// The weld without a sort. Every edge of the six tetrahedra runs from its
// lower grid vertex lo to lo plus one of seven positive offsets, in
// ascending order +z, +y, +y+z, +x, +x+z, +x+y, +x+y+z (rank 0-6): so the
// twin's key order is the order of (lo, rank), and a vertex's index is the
// number of mesh edges before it in that order. An edge is a mesh edge when
// its ends lie on either side of iso and some cube that contains it has no
// NaN corner (the twin draws vertices from emitted faces only). A grid line
// (x, y) holds the vertices lo = (x, y, 0..Rz-1) and the cubes with those
// origins, so line order is vertex order and cube order at once.
//
// Passes (ops/isosurface.py marching_tetrahedra_launch). A chunk is 128 z of
// a grid line, a lane taking 4 consecutive z: it loads its values (or bytes)
// at z .. z + 4 at once, so the corners of z + 1 carry over in registers and
// a warp keeps many loads in flight (with one z a lane it waits on each row);
//   MT1 mt_classify: a block takes a tile of 32 lines, a warp 4 lines in
//       turn, with 32-bit offsets and no division; it writes one byte per
//       grid vertex: its mesh edges (bits 0-6, by rank) and whether the cube
//       at it is active (bit 7); a lane whose eight corners lie on one side
//       writes 0 at once. Per line it writes its faces, its vertices and a
//       32-bit mask of its chunks with a non-zero byte; per tile its active
//       cubes, faces and vertices;
//   MT1 mt_scan: one block scans the tiles' counts: each tile's first face
//       and first vertex, and the totals, which the host reads (the pass's
//       one sync) to size the mesh;
//   MT2 mt_emit: a warp per line with faces visits the chunks that the masks
//       of its line and of the lines x + 1, y + 1, x + 1 and y + 1 mark,
//       with a running count of each line's vertices (warp scans); the
//       chunk's faces are then dealt to the lanes one each, in face order (a
//       binary search over the lanes' face counts finds a face's cube), and
//       each vertex index is its line's first vertex + the vertices before
//       lo on that line + the mesh edges of lo of lower rank;
//   MT2 mt_verts: a warp per line with vertices deals the mesh edges of its
//       marked chunks to the lanes the same way and interpolates each into
//       its slot.
// A grid of 2^31 points or more runs the same kernels with 64-bit offsets
// (chosen by the caller from the grid's size, or asked for).
//
// What bounds it on an H100: MT1 reads the grid and writes a byte per grid
// vertex (537 + 134 MB at 512^3: 0.20 ms at 3.35 TB/s); MT2 reads the active
// cubes' corners and the bytes of the chunks it visits and writes 24 bytes
// a face and 12 a vertex (0.03 ms for the 512^3 sphere's mesh). Neither
// reaches its bound: MT1's warps wait on their chunk's loads, MT2 on the
// chain of dependent loads of a face (bytes, corners, the gradient of its
// orientation), and the pass on the host between the launches.
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

// a cube's faces by its 8-bit inside mask: the sum over its 6 tetrahedra
struct CubeTable {
  int faces[256];
};

constexpr CubeTable make_cube_table() {
  constexpr int tets[6][4] = {{0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
                              {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7}};
  const TetTable t = make_table();
  CubeTable c{};
  for (int m = 0; m < 256; ++m) {
    int n = 0;
    for (int k = 0; k < 6; ++k) {
      int mask = 0;
      for (int j = 0; j < 4; ++j) mask |= ((m >> tets[k][j]) & 1) << j;
      n += t.count[mask];
    }
    c.faces[m] = n;
  }
  return c;
}

__constant__ TetTable kTable = make_table();
__constant__ CubeTable kCube = make_cube_table();

constexpr int kWarps = 8;  // warps per block
constexpr int kBlock = 32 * kWarps;
constexpr int kLinesPerWarp = 4;  // MT1: the grid lines a warp walks in turn
constexpr int kTileLines = kWarps * kLinesPerWarp;  // a tile: an MT1 block's 32 lines
constexpr int kRun = 4;  // the z a lane takes in a chunk
constexpr int kChunk = 32 * kRun;  // a chunk: 128 z of a line
constexpr unsigned kFull = 0xffffffffu;

// rank r of an edge's offset -> its far corner (x = 1, y = 2, z = 4): r + 1
// is the offset's (x, y, z) read as a 3-bit number, x high
__device__ __forceinline__ int corner_of_rank(int r) {
  const int b = r + 1;
  return ((b >> 2) & 1) | (b & 2) | ((b & 1) << 2);
}

__device__ __forceinline__ int rank_of_corner(int c) {
  return (((c & 1) << 2) | (c & 2) | ((c >> 2) & 1)) - 1;
}

// the chunks that one bit of a line's occupancy mask stands for (32 bits)
__device__ __forceinline__ int chunks_per_bit(int rz) {
  const int chunks = (rz + kChunk - 1) / kChunk;
  return (chunks + 31) / 32;
}

template <typename I>
struct Grid {
  const float* v;
  int rx, ry, rz;
  float iso;
  bool vec;  // Rz a multiple of 4 and v 16-byte aligned: a lane's run is one float4
  __device__ __forceinline__ I offset(int x, int y, int z) const {
    return (static_cast<I>(x) * static_cast<I>(ry) + static_cast<I>(y)) * static_cast<I>(rz) +
           static_cast<I>(z);
  }
};

template <typename T>
__device__ __forceinline__ T warp_inclusive_sum(T v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  return static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(v)));
}

// A cube without a NaN corner
template <typename I>
__device__ bool cube_valid(const Grid<I>& g, int x, int y, int z) {
  bool ok = true;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float v = g.v[g.offset(x + (c & 1), y + ((c >> 1) & 1), z + (c >> 2))];
    ok = ok && v == v;
  }
  return ok;
}

// The crossed edges of lo = (x, y, z) (bits by rank) that some cube other
// than the one at lo contains without a NaN corner: the cubes at lo - s for
// each non-empty s of the axes the edge does not move along. Reached only
// where the cube at lo does not exist (a far face) or has a NaN corner.
template <typename I>
__device__ unsigned owned_elsewhere(const Grid<I>& g, int x, int y, int z, unsigned crossed) {
  unsigned owned = 0;
  for (int r = 0; r < 7; ++r) {
    if (!((crossed >> r) & 1)) continue;
    const int rest = 7 & ~corner_of_rank(r);
    bool any = false;
    for (int s = rest; s != 0 && !any; s = (s - 1) & rest) {
      const int ox = x - (s & 1), oy = y - ((s >> 1) & 1), oz = z - ((s >> 2) & 1);
      if (ox < 0 || oy < 0 || oz < 0 || ox > g.rx - 2 || oy > g.ry - 2 || oz > g.rz - 2)
        continue;
      any = cube_valid(g, ox, oy, oz);
    }
    if (any) owned |= 1u << r;
  }
  return owned;
}

// A pair of rows (x, y') and (x + 1, y') at a lane's z .. z + 4, loaded
// ahead of their use. A row beyond the grid, or z beyond it, reads as 0.
// Where Rz is a multiple of 4 (Grid::vec) a row's first four values are one
// aligned float4 and the fifth, the next lane's first, comes by a shuffle in
// pair_bits (lane 31 loads its own); else five loads a row.
struct PairRaw {
  float a[kRun + 1], b[kRun + 1];
};

template <typename I>
__device__ __forceinline__ PairRaw load_pair(const Grid<I>& g, I row, bool has_x1, bool has_row,
                                             int zl) {
  const I next_x = static_cast<I>(g.ry) * static_cast<I>(g.rz);
  PairRaw p;
#pragma unroll
  for (int j = 0; j <= kRun; ++j) p.a[j] = p.b[j] = 0.0f;
  if (g.vec) {
    if (has_row && zl < g.rz) {
      const float4 a = *reinterpret_cast<const float4*>(g.v + row + zl);
      p.a[0] = a.x, p.a[1] = a.y, p.a[2] = a.z, p.a[3] = a.w;
      if (has_x1) {
        const float4 b = *reinterpret_cast<const float4*>(g.v + row + next_x + zl);
        p.b[0] = b.x, p.b[1] = b.y, p.b[2] = b.z, p.b[3] = b.w;
      }
    }
    if ((threadIdx.x & 31) == 31 && has_row && zl + kRun < g.rz) {
      p.a[kRun] = g.v[row + zl + kRun];
      if (has_x1) p.b[kRun] = g.v[row + next_x + zl + kRun];
    }
  } else {
#pragma unroll
    for (int j = 0; j <= kRun; ++j) {
      if (has_row && zl + j < g.rz) {
        p.a[j] = g.v[row + zl + j];
        if (has_x1) p.b[j] = g.v[row + next_x + zl + j];
      }
    }
  }
  return p;
}

// The 4 bits of two values: bit 0 / 1 below iso, bit 2 / 3 NaN
__device__ __forceinline__ unsigned pair_nibble(float a, float b, float iso) {
  return (a < iso ? 1u : 0u) | (b < iso ? 2u : 0u) | (a != a ? 4u : 0u) | (b != b ? 8u : 0u);
}

// A loaded pair as bits, 4 per z (at bits 4j). Called by whole warps.
template <typename I>
__device__ __forceinline__ unsigned pair_bits(const Grid<I>& g, const PairRaw& p) {
  float a4 = p.a[kRun], b4 = p.b[kRun];
  if (g.vec) {
    const float na = __shfl_down_sync(kFull, p.a[0], 1), nb = __shfl_down_sync(kFull, p.b[0], 1);
    if ((threadIdx.x & 31) != 31) a4 = na, b4 = nb;
  }
  unsigned bits = pair_nibble(a4, b4, g.iso) << (4 * kRun);
#pragma unroll
  for (int j = 0; j < kRun; ++j) bits |= pair_nibble(p.a[j], p.b[j], g.iso) << (4 * j);
  return bits;
}

// The four rows of a line at its lane's z + j from the pairs at y and at
// y + 1: bit d below iso, bit 4 + d NaN, row d = (x + (d & 1), y + (d >> 1))
__device__ __forceinline__ unsigned row_bits(unsigned at_y, unsigned at_y1, int j) {
  const unsigned a = (at_y >> (4 * j)) & 0xfu, b = (at_y1 >> (4 * j)) & 0xfu;
  return (a & 3u) | ((b & 3u) << 2) | (((a >> 2) & 3u) << 4) | (((b >> 2) & 3u) << 6);
}

// The byte of grid vertex lo = (x, y, z) and its cube, from the row bits at
// z and z + 1 (cube corner c is row c & 3 at z + (c >> 2), so the two give
// the cube's inside and NaN masks in corner order): the mesh edges by rank
// (bits 0-6) and the cube active (bit 7); adds to the counts.
template <typename I>
__device__ __forceinline__ unsigned vertex_byte(const Grid<I>& g, int x, int y, int z,
                                                const bool (&has)[4], unsigned at_z,
                                                unsigned at_z1, int& n_active, int& n_faces,
                                                int& n_verts) {
  const unsigned inside = (at_z & 0xfu) | ((at_z1 & 0xfu) << 4);
  const unsigned nans = (at_z >> 4) | (at_z1 & 0xf0u);
  // all eight on one side and no NaN (the common case): no mesh edge, no
  // active cube; the zeros read beyond the grid at worst send a vertex on
  // a far face the long way
  if ((inside == 0u || inside == 0xffu) && nans == 0u) return 0u;
  const bool hz = z + 1 < g.rz;
  const bool valid = hz && has[3] && nans == 0u;
  const bool active = valid && inside != 0u && inside != 0xffu;
  unsigned crossed = 0;
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    const int c = corner_of_rank(r);
    const bool in_range = has[c & 3] && (!(c & 4) || hz);
    crossed |= (in_range && (((inside >> c) ^ inside) & 1u) ? 1u : 0u) << r;
  }
  // the cube at lo contains all seven: where it is valid, every crossed edge
  // is a mesh edge
  const unsigned edges = valid ? crossed : (crossed ? owned_elsewhere(g, x, y, z, crossed) : 0u);
  n_active += active ? 1 : 0;
  n_faces += active ? kCube.faces[inside] : 0;
  n_verts += __popc(edges);
  return edges | (active ? 0x80u : 0u);
}

// MT1. A block takes a tile of 32 grid lines, each warp 4 consecutive ones;
// a warp walks its lines chunk by chunk, a lane taking 4 consecutive z, so
// the corners of z + 1 carry over in registers. At the start of a chunk the
// warp loads every pair of rows its lines need at once (lines (x, y) ..
// (x, y + 3) need the pairs at y .. y + 4: two rows a line, not four, and
// ten loads in flight a lane), then takes the lines in turn. Per line it
// writes the bytes, its faces and vertices and a 32-bit mask of the chunks
// with a non-zero byte; per tile the sums.
template <typename I>
__global__ void __launch_bounds__(kBlock, 2)
    mt_classify_kernel(Grid<I> g, uint8_t* __restrict__ flags, int4* __restrict__ line_info,
                       long long* __restrict__ tile_sums) {
  __shared__ int sums[kWarps][3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_lines = static_cast<long long>(g.rx) * g.ry;
  const long long first = static_cast<long long>(blockIdx.x) * kTileLines + warp * kLinesPerWarp;
  const int per_bit = chunks_per_bit(g.rz);
  int n_active = 0, n_faces[kLinesPerWarp], n_verts[kLinesPerWarp];
  unsigned occupied[kLinesPerWarp];
#pragma unroll
  for (int i = 0; i < kLinesPerWarp; ++i) n_faces[i] = n_verts[i] = occupied[i] = 0;
  for (int z0 = 0, k = 0; z0 < g.rz && first < n_lines; z0 += kChunk, ++k) {
    const int zl = z0 + lane * kRun;
    PairRaw raw[kLinesPerWarp + 1];  // [0]: the pair at the first line's y; [i + 1]: line i's y + 1
#pragma unroll
    for (int i = 0; i < kLinesPerWarp; ++i) {
      const long long line = first + i;
      if (line >= n_lines) break;  // warp-uniform
      const int x = static_cast<int>(line / g.ry), y = static_cast<int>(line % g.ry);
      const bool hx = x + 1 < g.rx;
      const I row = g.offset(x, y, 0);
      if (i == 0) raw[0] = load_pair(g, row, hx, true, zl);
      raw[i + 1] = load_pair(g, row + static_cast<I>(g.rz), hx, y + 1 < g.ry, zl);
    }
    unsigned at_y = pair_bits(g, raw[0]);
#pragma unroll
    for (int i = 0; i < kLinesPerWarp; ++i) {
      const long long line = first + i;
      if (line >= n_lines) break;  // warp-uniform
      const int x = static_cast<int>(line / g.ry), y = static_cast<int>(line % g.ry);
      const bool hx = x + 1 < g.rx, hy = y + 1 < g.ry;
      const bool has[4] = {true, hx, hy, hx && hy};
      const I row = g.offset(x, y, 0);
      if (i > 0 && y == 0) at_y = pair_bits(g, load_pair(g, row, hx, true, zl));  // a new x
      const unsigned at_y1 = pair_bits(g, raw[i + 1]);
      // the lane's five z of the four rows all on one side, without NaN (the
      // common case): four zero bytes at once
      const unsigned below = at_y & at_y1 & 0x33333u, either = (at_y | at_y1) & 0xfffffu;
      unsigned word = 0;
      if (!(either == 0u || (below == 0x33333u && (either & 0xcccccu) == 0u))) {
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          if (zl + j >= g.rz) break;
          word |= vertex_byte(g, x, y, zl + j, has, row_bits(at_y, at_y1, j),
                              row_bits(at_y, at_y1, j + 1), n_active, n_faces[i], n_verts[i])
                  << (8 * j);
        }
      }
      if (g.vec && zl < g.rz) {  // whole aligned words (the flags are 16-byte aligned)
        *reinterpret_cast<uint32_t*>(flags + row + zl) = word;
      } else {
#pragma unroll
        for (int j = 0; j < kRun; ++j)
          if (zl + j < g.rz) flags[row + zl + j] = static_cast<uint8_t>(word >> (8 * j));
      }
      if (__any_sync(kFull, word != 0u)) occupied[i] |= 1u << (k / per_bit);
      at_y = at_y1;  // the next line's pair at its y, unless it starts a new x
    }
  }
  int t_faces = 0, t_verts = 0;
#pragma unroll
  for (int i = 0; i < kLinesPerWarp; ++i) {
    const int f = warp_sum(n_faces[i]), v = warp_sum(n_verts[i]);
    if (lane == 0 && first + i < n_lines)
      line_info[first + i] = make_int4(f, v, static_cast<int>(occupied[i]), 0);
    t_faces += f;
    t_verts += v;
  }
  n_active = warp_sum(n_active);
  if (lane == 0) {
    sums[warp][0] = n_active;
    sums[warp][1] = t_faces;
    sums[warp][2] = t_verts;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    long long s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sums[w][threadIdx.x];
    tile_sums[3 * static_cast<long long>(blockIdx.x) + threadIdx.x] = s;
  }
}

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;

// MT1, the scan: one block, kScanThreads x kScanItems tiles a round (one
// round up to 8,192 tiles: a 512^2 plane of lines).
// tile_bases (tiles, 2): each tile's first face and first vertex; totals:
// active cubes, faces, vertices.
__global__ void __launch_bounds__(kScanThreads)
    mt_scan_kernel(const long long* __restrict__ tile_sums, long long n_tiles,
                   long long* __restrict__ tile_bases, long long* __restrict__ totals) {
  __shared__ long long warp_sums[32][3];
  __shared__ long long carry[3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < 3) carry[threadIdx.x] = 0;
  __syncthreads();
  for (long long start = 0; start < n_tiles; start += kScanThreads * kScanItems) {
    const long long first = start + static_cast<long long>(threadIdx.x) * kScanItems;
    long long v[kScanItems][3], own[3] = {0, 0, 0};
#pragma unroll
    for (int i = 0; i < kScanItems; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v[i][k] = first + i < n_tiles ? tile_sums[3 * (first + i) + k] : 0;
        own[k] += v[i][k];
      }
    long long inc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) inc[k] = warp_inclusive_sum(own[k], lane);
    if (lane == 31)
#pragma unroll
      for (int k = 0; k < 3; ++k) warp_sums[warp][k] = inc[k];
    __syncthreads();
    if (warp == 0)
#pragma unroll
      for (int k = 0; k < 3; ++k) warp_sums[lane][k] = warp_inclusive_sum(warp_sums[lane][k], lane);
    __syncthreads();
    long long base[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      base[k] = carry[k] + (warp > 0 ? warp_sums[warp - 1][k] : 0) + inc[k] - own[k];
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (first + i < n_tiles) {
        tile_bases[2 * (first + i)] = base[1];
        tile_bases[2 * (first + i) + 1] = base[2];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) base[k] += v[i][k];
    }
    __syncthreads();
    if (threadIdx.x < 3) carry[threadIdx.x] += warp_sums[31][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.x < 3) totals[threadIdx.x] = carry[threadIdx.x];
}

// The first face (k = 0) or vertex (k = 1) of a line: its tile's base plus
// the lines before it in the tile. Warp-collective.
__device__ __forceinline__ long long line_base(const int4* __restrict__ line_info,
                                               const long long* __restrict__ tile_bases,
                                               long long line, int k, int lane) {
  const long long tile = line / kTileLines;
  const int before = static_cast<int>(line - tile * kTileLines);
  int n = 0;
  if (lane < before) {
    const int4 c = line_info[tile * kTileLines + lane];
    n = k == 0 ? c.x : c.y;
  }
  long long sum = n;  // 31 lines of up to 12 (Rz - 1) faces: in 64 bits
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  return tile_bases[2 * tile + k] + sum;
}

// the vertex of an edge from grid point pa (value va) to pb (value vb)
__device__ __forceinline__ void interpolate(float va, float vb, float iso, const float (&pa)[3],
                                            const float (&pb)[3], float (&out)[3]) {
  const float denom = vb - va;
  float t = fabsf(denom) > 1e-12f ? (iso - va) / denom : 0.5f;
  t = t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
#pragma unroll
  for (int d = 0; d < 3; ++d) out[d] = pa[d] + t * (pb[d] - pa[d]);
}

// np.clip(np.round(c).astype(int64), 1, R - 2), and a numpy index that may be -1
__device__ __forceinline__ int round_clip(float c, int r) {
  int i = static_cast<int>(rintf(c));
  i = i < 1 ? 1 : i;
  return i > r - 2 ? r - 2 : i;
}

__device__ __forceinline__ int wrap(int i, int r) { return i < 0 ? i + r : i; }

template <typename I>
__device__ __forceinline__ float at(const Grid<I>& g, int x, int y, int z) {
  return g.v[g.offset(wrap(x, g.rx), wrap(y, g.ry), wrap(z, g.rz))];
}

// true when the face (p0, p1, p2) must be reversed to face increasing values
template <typename I>
__device__ __forceinline__ bool flip_face(const Grid<I>& g, const float (&p)[3][3]) {
  float c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) c[d] = ((p[0][d] + p[1][d]) + p[2][d]) / 3.0f;
  const int gx = round_clip(c[0], g.rx), gy = round_clip(c[1], g.ry), gz = round_clip(c[2], g.rz);
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

// the value of line d (0-3) among four
template <typename T>
__device__ __forceinline__ T pick(int d, T a0, T a1, T a2, T a3) {
  return d == 0 ? a0 : (d == 1 ? a1 : (d == 2 ? a2 : a3));
}

// The tetrahedron tables of kTable / kTets / kTetEdges in shared memory:
// lanes read them at different entries (their cubes' masks)
struct SharedTables {
  int tris[16][2][3];
  int count[16];
  int tets[6][4];
  int tet_edges[6][2];
};

__device__ __forceinline__ void load_tables(SharedTables& t) {
  for (int i = threadIdx.x; i < 16 * 2 * 3; i += blockDim.x)
    (&t.tris[0][0][0])[i] = (&kTable.tris[0][0][0])[i];
  for (int i = threadIdx.x; i < 16; i += blockDim.x) t.count[i] = kTable.count[i];
  for (int i = threadIdx.x; i < 24; i += blockDim.x) (&t.tets[0][0])[i] = (&kTets[0][0])[i];
  for (int i = threadIdx.x; i < 12; i += blockDim.x)
    (&t.tet_edges[0][0])[i] = (&kTetEdges[0][0])[i];
  __syncthreads();
}

// The first lane whose inclusive count exceeds q (q below the warp's total):
// a binary search over the lanes' counts. Warp-collective.
__device__ __forceinline__ int lane_of(int inc, int q) {
  int src = 0;
#pragma unroll
  for (int b = 16; b >= 1; b >>= 1)
    if (__shfl_sync(kFull, inc, src + b - 1) <= q) src += b;
  return src;
}

// A cube's view of the four lines around it: per line (8 bits each) the
// mesh edges at z and at z + 1, and the vertices of that line before z
struct CubeView {
  unsigned edges, next;
  long long before[4];
};

// MT2, face `k` of tetrahedron `t` of the active cube at (x, y, z), written
// at face f
template <typename I>
__device__ void emit_face(const Grid<I>& g, const SharedTables& tab, int x, int y, int z,
                          unsigned inside, int t, int k, const CubeView& w, long long f,
                          int64_t* __restrict__ faces) {
  int mask = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) mask |= ((inside >> tab.tets[t][j]) & 1) << j;
  float p[3][3];
  long long id[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int e = tab.tris[mask][k][j];
    const int ca = tab.tets[t][tab.tet_edges[e][0]], cb = tab.tets[t][tab.tet_edges[e][1]];
    const int lo = ca & cb, hi = ca | cb, d = lo & 3;
    const unsigned below = (1u << rank_of_corner(hi ^ lo)) - 1u;
    const unsigned at_z = (w.edges >> (8 * d)) & 0x7fu;
    const long long before = pick(d, w.before[0], w.before[1], w.before[2], w.before[3]);
    id[j] = (lo & 4) ? before + __popc(at_z) + __popc((w.next >> (8 * d)) & below)
                     : before + __popc(at_z & below);
    const int ax = x + (lo & 1), ay = y + ((lo >> 1) & 1), az = z + (lo >> 2);
    const int bx = x + (hi & 1), by = y + ((hi >> 1) & 1), bz = z + (hi >> 2);
    const float pa[3] = {static_cast<float>(ax), static_cast<float>(ay), static_cast<float>(az)};
    const float pb[3] = {static_cast<float>(bx), static_cast<float>(by), static_cast<float>(bz)};
    interpolate(g.v[g.offset(ax, ay, az)], g.v[g.offset(bx, by, bz)], g.iso, pa, pb, p[j]);
  }
  const bool flip = flip_face(g, p);
  faces[3 * f] = flip ? id[2] : id[0];
  faces[3 * f + 1] = id[1];
  faces[3 * f + 2] = flip ? id[0] : id[2];
}

// A lane's kRun bytes of one line from z (byte j at bits 8j), and the byte
// after them (the next lane's first)
template <typename I>
__device__ __forceinline__ unsigned lane_bytes(const uint8_t* __restrict__ flags, I row, int z,
                                               int rz, unsigned& after) {
  unsigned word = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j)
    word |= (z + j < rz ? static_cast<unsigned>(flags[row + z + j]) : 0u) << (8 * j);
  after = z + kRun < rz ? flags[row + z + kRun] : 0u;
  return word;
}

// MT2, the faces: one warp per line with faces (x < Rx - 1, y < Ry - 1). It
// visits the chunks that the four lines' occupancy masks mark, a lane taking
// 4 consecutive z as in MT1: the bytes of the four lines, the running
// vertex counts of each line and the faces of the lane's active cubes (warp
// scans of the lanes' counts). Then the chunk's faces are dealt to the lanes
// one each, in face order: a lane finds its face's cube by a binary search
// over the lanes' face counts, takes that lane's bytes and counts with
// shuffles, and writes the face at its scanned offset.
template <typename I>
__global__ void __launch_bounds__(kBlock, 4)
    mt_emit_kernel(Grid<I> g, const uint8_t* __restrict__ flags,
                   const int4* __restrict__ line_info, const long long* __restrict__ tile_bases,
                   int64_t* __restrict__ faces) {
  __shared__ SharedTables tab;
  load_tables(tab);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_lines = static_cast<long long>(g.rx) * g.ry;
  const long long line = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (line >= n_lines || line_info[line].x == 0) return;  // warp-uniform
  const int x = static_cast<int>(line / g.ry), y = static_cast<int>(line % g.ry);
  I rows[4];
  long long carry[4];
  unsigned occupied = 0;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const long long ld = line + (d & 1) * g.ry + (d >> 1);
    rows[d] = g.offset(x + (d & 1), y + (d >> 1), 0);
    carry[d] = line_base(line_info, tile_bases, ld, 1, lane);
    occupied |= static_cast<unsigned>(line_info[ld].z);
  }
  long long f_carry = line_base(line_info, tile_bases, line, 0, lane);
  const int per_bit = chunks_per_bit(g.rz);
  for (int z0 = 0, k = 0; z0 < g.rz; z0 += kChunk, ++k) {
    if (!((occupied >> (k / per_bit)) & 1u)) continue;  // four lines of zero bytes
    const int zl = z0 + lane * kRun;
    unsigned word[4], after[4];
    long long before[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      word[d] = lane_bytes(flags, rows[d], zl, g.rz, after[d]);
      const int n = __popc(word[d] & 0x7f7f7f7fu);
      const int inc = warp_inclusive_sum(n, lane);
      before[d] = carry[d] + inc - n;
      carry[d] += __shfl_sync(kFull, inc, 31);
    }
    // the lane's active cubes: inside masks (byte j) and faces (4 bits each)
    unsigned insides = 0, counts = 0;
    int n_faces = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (!((word[0] >> (8 * j + 7)) & 1u)) continue;
      unsigned inside = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        inside |= (g.v[rows[c & 3] + zl + j + (c >> 2)] < g.iso ? 1u : 0u) << c;
      const int n = kCube.faces[inside];
      insides |= inside << (8 * j);
      counts |= static_cast<unsigned>(n) << (4 * j);
      n_faces += n;
    }
    const int inc = warp_inclusive_sum(n_faces, lane);
    const int total = __shfl_sync(kFull, inc, 31);
    for (int q0 = 0; q0 < total; q0 += 32) {
      const int q = q0 + lane;  // this lane's face of the chunk
      const int src = lane_of(inc, q);  // the lane whose cubes hold it
      int local = q - (__shfl_sync(kFull, inc, src) - __shfl_sync(kFull, n_faces, src));
      const unsigned src_counts = __shfl_sync(kFull, counts, src);
      const unsigned src_insides = __shfl_sync(kFull, insides, src);
      CubeView w;
      unsigned src_word[4], src_after[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        src_word[d] = __shfl_sync(kFull, word[d], src);
        src_after[d] = __shfl_sync(kFull, after[d], src);
        w.before[d] = __shfl_sync(kFull, before[d], src);
      }
      if (q >= total) continue;
      int j = 0;  // the cube among the source lane's run, and the face in it
      while (local >= static_cast<int>((src_counts >> (4 * j)) & 0xfu)) {
        local -= (src_counts >> (4 * j)) & 0xfu;
        ++j;
      }
      const unsigned inside = (src_insides >> (8 * j)) & 0xffu;
      int t = 0;  // the tetrahedron and its triangle
      for (;; ++t) {
        int mask = 0;
#pragma unroll
        for (int m = 0; m < 4; ++m) mask |= ((inside >> tab.tets[t][m]) & 1) << m;
        if (local < tab.count[mask]) break;
        local -= tab.count[mask];
      }
      w.edges = 0;
      w.next = 0;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const unsigned below_j = j == 0 ? 0u : src_word[d] & (0xffffffffu >> (32 - 8 * j));
        w.before[d] += __popc(below_j & 0x7f7f7f7fu);
        w.edges |= ((src_word[d] >> (8 * j)) & 0x7fu) << (8 * d);
        const unsigned nx =
            j + 1 < kRun ? (src_word[d] >> (8 * (j + 1))) & 0x7fu : src_after[d] & 0x7fu;
        w.next |= nx << (8 * d);
      }
      emit_face(g, tab, x, y, z0 + src * kRun + j, inside, t, local, w, f_carry + q, faces);
    }
    f_carry += total;
  }
}

// MT2, the vertices: one warp per line with mesh edges, over the chunks its
// occupancy mask marks, a lane taking 4 consecutive z; the chunk's vertices
// are then dealt to the lanes one each, in vertex order.
template <typename I>
__global__ void __launch_bounds__(kBlock)
    mt_verts_kernel(Grid<I> g, const uint8_t* __restrict__ flags,
                    const int4* __restrict__ line_info, const long long* __restrict__ tile_bases,
                    float* __restrict__ verts) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_lines = static_cast<long long>(g.rx) * g.ry;
  const long long line = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (line >= n_lines) return;
  const int4 info = line_info[line];
  if (info.y == 0) return;  // warp-uniform
  const int x = static_cast<int>(line / g.ry), y = static_cast<int>(line % g.ry);
  const I row = g.offset(x, y, 0);
  long long carry = line_base(line_info, tile_bases, line, 1, lane);
  const unsigned occupied = static_cast<unsigned>(info.z);
  const int per_bit = chunks_per_bit(g.rz);
  for (int z0 = 0, k = 0; z0 < g.rz; z0 += kChunk, ++k) {
    if (!((occupied >> (k / per_bit)) & 1u)) continue;
    unsigned after;
    const unsigned word = lane_bytes(flags, row, z0 + lane * kRun, g.rz, after) & 0x7f7f7f7fu;
    const int n = __popc(word);
    const int inc = warp_inclusive_sum(n, lane);
    const int total = __shfl_sync(kFull, inc, 31);
    for (int q0 = 0; q0 < total; q0 += 32) {
      const int q = q0 + lane;  // this lane's vertex of the chunk
      const int src = lane_of(inc, q);
      int local = q - (__shfl_sync(kFull, inc, src) - __shfl_sync(kFull, n, src));
      const unsigned src_word = __shfl_sync(kFull, word, src);
      if (q >= total) continue;
      int j = 0;  // the grid vertex of the source lane's run, and the edge's rank
      while (local >= __popc((src_word >> (8 * j)) & 0x7fu)) {
        local -= __popc((src_word >> (8 * j)) & 0x7fu);
        ++j;
      }
      unsigned edges = (src_word >> (8 * j)) & 0x7fu;
      for (; local > 0; --local) edges &= edges - 1u;
      const int c = corner_of_rank(__ffs(edges) - 1);
      const int z = z0 + src * kRun + j;
      const int hx = x + (c & 1), hy = y + ((c >> 1) & 1), hz = z + (c >> 2);
      const float pa[3] = {static_cast<float>(x), static_cast<float>(y), static_cast<float>(z)};
      const float pb[3] = {static_cast<float>(hx), static_cast<float>(hy), static_cast<float>(hz)};
      float p[3];
      interpolate(g.v[row + z], g.v[g.offset(hx, hy, hz)], g.iso, pa, pb, p);
      const long long i = carry + q;
#pragma unroll
      for (int d = 0; d < 3; ++d) verts[3 * i + d] = p[d];
    }
    carry += total;
  }
}

constexpr long long kNarrowPoints = 1LL << 31;  // 32-bit offsets below this

// -1 for a grid the kernels do not take: an axis under 2 or of 2^24 points
// or more (grid coordinates exact in float32, a line's faces in 32 bits), or
// 32-bit offsets asked for a grid of 2^31 points or more
inline int grid_ok(long long rx, long long ry, long long rz, int wide) {
  const long long cap = 1LL << 24;
  if (rx < 2 || ry < 2 || rz < 2 || rx >= cap || ry >= cap || rz >= cap) return -1;
  if (!wide && rx * ry * rz >= kNarrowPoints) return -1;
  return 0;
}

inline unsigned blocks_of(long long rx, long long ry, int lines_per_block) {
  return static_cast<unsigned>((rx * ry + lines_per_block - 1) / lines_per_block);
}

template <typename I>
inline Grid<I> make_grid(const float* values, long long rx, long long ry, long long rz, float iso) {
  const bool vec = rz % kRun == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0;
  return Grid<I>{values, static_cast<int>(rx), static_cast<int>(ry), static_cast<int>(rz), iso, vec};
}

}  // namespace insr

// MT1. values (rx, ry, rz) float32, indexed (x * ry + y) * rz + z, each axis
// >= 2; wide: 64-bit offsets (required from 2^31 points); flags (rx * ry *
// rz,) uint8, a grid vertex's mesh edges by rank and its cube's activity;
// line_info (rx * ry, 4) int32, each line's faces, vertices and mask of
// occupied chunks; tile_sums (tiles, 3) int64, each tile's active cubes,
// faces and vertices, tiles = ceil(rx * ry / 32); flags 16-byte aligned.
// Returns -1 for a grid it does not take, else cudaGetLastError() after the
// launch.
extern "C" int mt_classify(const float* values, long long rx, long long ry, long long rz,
                           float iso, int wide, uint8_t* flags, int* line_info,
                           long long* tile_sums, void* stream) {
  if (insr::grid_ok(rx, ry, rz, wide) || reinterpret_cast<uintptr_t>(flags) % 16) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  int4* li = reinterpret_cast<int4*>(line_info);
  const unsigned blocks = insr::blocks_of(rx, ry, insr::kTileLines);
  if (wide)
    insr::mt_classify_kernel<uint64_t><<<blocks, insr::kBlock, 0, s>>>(
        insr::make_grid<uint64_t>(values, rx, ry, rz, iso), flags, li, tile_sums);
  else
    insr::mt_classify_kernel<uint32_t><<<blocks, insr::kBlock, 0, s>>>(
        insr::make_grid<uint32_t>(values, rx, ry, rz, iso), flags, li, tile_sums);
  return static_cast<int>(cudaGetLastError());
}

// MT1, the scan of mt_classify's tile_sums: tile_bases (tiles, 2) int64,
// each tile's first face and first vertex; totals (3,) int64: active cubes,
// faces, vertices.
extern "C" int mt_scan(const long long* tile_sums, long long n_tiles, long long* tile_bases,
                       long long* totals, void* stream) {
  insr::mt_scan_kernel<<<1, insr::kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tile_sums, n_tiles, tile_bases, totals);
  return static_cast<int>(cudaGetLastError());
}

// MT2, the faces: faces (totals[1], 3) int64, from MT1's flags, line_info
// and tile_bases, with the same wide as mt_classify.
extern "C" int mt_emit(const float* values, long long rx, long long ry, long long rz, float iso,
                       int wide, const uint8_t* flags, const int* line_info,
                       const long long* tile_bases, int64_t* faces, void* stream) {
  if (insr::grid_ok(rx, ry, rz, wide)) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const int4* li = reinterpret_cast<const int4*>(line_info);
  const unsigned blocks = insr::blocks_of(rx, ry, insr::kWarps);
  if (wide)
    insr::mt_emit_kernel<uint64_t><<<blocks, insr::kBlock, 0, s>>>(
        insr::make_grid<uint64_t>(values, rx, ry, rz, iso), flags, li, tile_bases, faces);
  else
    insr::mt_emit_kernel<uint32_t><<<blocks, insr::kBlock, 0, s>>>(
        insr::make_grid<uint32_t>(values, rx, ry, rz, iso), flags, li, tile_bases, faces);
  return static_cast<int>(cudaGetLastError());
}

// MT2, the vertices: verts (totals[2], 3) float32 in grid coordinates.
extern "C" int mt_verts(const float* values, long long rx, long long ry, long long rz, float iso,
                        int wide, const uint8_t* flags, const int* line_info,
                        const long long* tile_bases, float* verts, void* stream) {
  if (insr::grid_ok(rx, ry, rz, wide)) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  const int4* li = reinterpret_cast<const int4*>(line_info);
  const unsigned blocks = insr::blocks_of(rx, ry, insr::kWarps);
  if (wide)
    insr::mt_verts_kernel<uint64_t><<<blocks, insr::kBlock, 0, s>>>(
        insr::make_grid<uint64_t>(values, rx, ry, rz, iso), flags, li, tile_bases, verts);
  else
    insr::mt_verts_kernel<uint32_t><<<blocks, insr::kBlock, 0, s>>>(
        insr::make_grid<uint32_t>(values, rx, ry, rz, iso), flags, li, tile_bases, verts);
  return static_cast<int>(cudaGetLastError());
}
