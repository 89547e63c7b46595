// Shared by the ordered kernels B3 (ordered_blend.cu) and B4
// (ordered_peel.cu): the ordered-row layout of raster/cuda_ordered.py
// (_OC_*), the launch geometry, and the walk of a tile's draw-ordered rows
// through a shared-memory ring with an exact strip scan and the per-pixel
// coverage of every row that survives it.
//
// Numerics: every edge, esum, depth and clip-plane value is an explicit
// round-to-nearest multiply or add in the reference's order of operations
// (the library also builds with --fmad=false), so coverage and the raw edge
// values equal the plain torch versions bit for bit.

#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "tile_scan.cuh"

namespace ck_ordered {

using namespace ck_tile;

// A row is a coverage head and a shade tail, each a multiple of 4 floats,
// so a 16-byte aligned stream keeps every row and every tail on 16 bytes.
// Head (all that coverage reads; B4 stages only this part), float4 quads:
//   q0 = e0.a e0.b e0.c e1.a     q1 = e1.b e1.c e2.a e2.b
//   q2 = e2.c z0 z1 z2           q3 = inv_det_s esum.a esum.b esum.c
//   q4 = s flags rect.x0 rect.y0 q5 = rect.x1 rect.y1 bits zfunc
//   q6 = id, then 3 per user clip plane, zeros up to the head width.
// Columns 0-21 are the opaque solve's (raster/tiled.py _C_*).
constexpr int kZ = 9;       // corner clip z (3)
constexpr int kIvs = 12;    // signed inverse determinant
constexpr int kEp = 13;     // esum plane (3)
constexpr int kSs = 16;     // sign s
constexpr int kFl = 17;     // top-left bits 1|2|4, valid bit 8
constexpr int kRect = 18;   // per-triangle scissor (4)
constexpr int kBits = 22;   // blend | fog<<1 | colorwrite<<2 | persp<<3 | at<<4
constexpr int kZf = 23;     // z compare func
constexpr int kId = 24;     // draw index
constexpr int kClip = 25;   // user clip planes, 3 each
// Shade tail, at the head width:
constexpr int kCol = 0;     // corner RGBA x3, corner-major (12)
constexpr int kSpc = 12;    // corner spec RGB x3 (9)
constexpr int kFog = 21;    // corner fog factors (3)
constexpr int kAf = 24;     // alpha compare func
constexpr int kAref = 25;   // alpha ref
constexpr int kWs = 26;     // corner w (3)
constexpr int kTail = 32;   // tail width (29 columns and 3 zeros)

__host__ __device__ constexpr int head_width(int n_planes) {
  return (kClip + 3 * n_planes + 3) / 4 * 4;
}

// D3D compare codes (raster/types.py VXCMP).
constexpr int kNever = 1;
constexpr int kLess = 2;
constexpr int kEqual = 3;
constexpr int kLessEqual = 4;
constexpr int kGreater = 5;
constexpr int kNotEqual = 6;
constexpr int kGreaterEqual = 7;

// D3D compare of incoming a against stored b; ALWAYS and unknown codes pass.
__device__ __forceinline__ bool compare(int func, float a, float b) {
  switch (func) {
    case kNever: return false;
    case kLess: return a < b;
    case kEqual: return a == b;
    case kLessEqual: return a <= b;
    case kGreater: return a > b;
    case kNotEqual: return a != b;
    case kGreaterEqual: return a >= b;
    default: return true;
  }
}

// torch.clamp(x, 0, 1): NaN stays NaN.
__device__ __forceinline__ float clamp01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

constexpr int kSub = 16;      // a CTA's sub-tile: kSub x kSub pixels
constexpr int kStages = 4;    // ring stages
constexpr unsigned kFullWarp = 0xffffffffu;

// Grid, threads per CTA and shared-memory bytes of a kernel whose CTA
// covers one kSub x kSub sub-tile with 1 x bw pixel blocks and stages
// `width` floats of each row; false when the shapes are not taken (a tile
// of 16 or 32 pixels, the pitch of the row layout).
struct Launch {
  dim3 grid, block;
  size_t smem;
  int pitch, plane_size;   // of the (H_pad, W_pad) output planes
};

inline bool geometry(int bw, int rpitch, int width, int n_planes, int tile,
                     int tiles_x, int tiles_y, int kchunk, Launch* g) {
  if ((tile != kSub && tile != 2 * kSub) || kchunk <= 0 || n_planes < 0 ||
      rpitch != head_width(n_planes) + kTail)
    return false;
  g->grid = dim3(tiles_x * tiles_y * (tile / kSub) * (tile / kSub));
  g->block = dim3(kSub * kSub / bw);
  g->smem = static_cast<size_t>(kStages) * kchunk * width * sizeof(float);
  g->pitch = tiles_x * tile;
  g->plane_size = g->pitch * tiles_y * tile;
  return true;
}

// A thread's 1 x BW block of pixel centres, its fixed per-pixel state and
// its warp's strip (the box of the warp's pixel centres).
template <int BW>
struct Block {
  static_assert(BW == 1 || BW == 2 || BW == 4, "1 x 1, 1 x 2 or 1 x 4");
  float px[BW];
  float py;
  float zb[BW];      // opaque depth
  bool sc[BW];       // viewport scissor and framebuffer bounds
  int pix;           // plane index of px[0]
  int tile;          // the screen tile
  float sxmin, sxmax, symin, symax;
  bool strip_live;   // some pixel of the strip passes the scissor
};

template <int BW>
__device__ __forceinline__ void load_block(const float* src,
                                           float (&v)[BW]) {
  if constexpr (BW == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(src));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (BW == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldg(src);
  }
}

// One 4-, 8- or 16-byte store of a block's values (a block starts on a
// multiple of BW pixels of a plane row that is a multiple of 16 wide).
template <int BW>
__device__ __forceinline__ void store_block(float* dst,
                                            const float (&v)[BW]) {
  if constexpr (BW == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (BW == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  else
    dst[0] = v[0];
}

template <int BW>
__device__ __forceinline__ void store_block(int* dst, const int (&v)[BW]) {
  if constexpr (BW == 4)
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  else if constexpr (BW == 2)
    *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
  else
    dst[0] = v[0];
}

// The CTA's sub-tile (blockIdx.x: tile-major, then the quadrant of a 32x32
// tile), the thread's block in it (row-major, kSub / BW blocks a row, so a
// warp holds whole block rows: lane 0 has the strip's least pixel centre in
// x and y and lane 31 its greatest) and its per-pixel state.
template <int BW>
__device__ __forceinline__ Block<BW> block_of(const float* params,
                                              const float* zplane, int tile,
                                              int tiles_x, int pitch) {
  Block<BW> b;
  const int subs_x = tile / kSub;
  b.tile = blockIdx.x / (subs_x * subs_x);
  const int sub = blockIdx.x - b.tile * subs_x * subs_x;
  const int ty = b.tile / tiles_x;
  const int tx = b.tile - ty * tiles_x;
  constexpr int kBlockCols = kSub / BW;
  const int gx = tx * tile + (sub % subs_x) * kSub +
                 (threadIdx.x % kBlockCols) * BW;
  const int gy = ty * tile + (sub / subs_x) * kSub + threadIdx.x / kBlockCols;
  b.pix = gy * pitch + gx;
  load_block<BW>(zplane + b.pix, b.zb);
  const float vx0 = __ldg(params);
  const float vy0 = __ldg(params + 1);
  const float vx1 = __fadd_rn(vx0, __ldg(params + 2));
  const float vy1 = __fadd_rn(vy0, __ldg(params + 3));
  const float fw = __ldg(params + 4);
  // The row's global centre (a band of a frame starts at global row
  // row0 = params[6]), and the framebuffer's end in global rows, row0 +
  // height (integers: exact), so that py < fh is the local bound.
  const float row0 = __ldg(params + 6);
  const float fh = __fadd_rn(row0, __ldg(params + 5));
  b.py = centre(gy, row0);
  bool any = false;
#pragma unroll
  for (int k = 0; k < BW; ++k) {
    b.px[k] = static_cast<float>(gx + k) + 0.5f;
    b.sc[k] = b.px[k] >= vx0 && b.px[k] < vx1 && b.py >= vy0 && b.py < vy1 &&
              b.px[k] < fw && b.py < fh;
    any = any || b.sc[k];
  }
  b.sxmin = __shfl_sync(kFullWarp, b.px[0], 0);
  b.symin = __shfl_sync(kFullWarp, b.py, 0);
  b.sxmax = __shfl_sync(kFullWarp, b.px[BW - 1], 31);
  b.symax = __shfl_sync(kFullWarp, b.py, 31);
  b.strip_live = __any_sync(kFullWarp, any);
  return b;
}

// The strip scan of one row (exact: it only drops rows that cover no pixel
// of the warp's strip). The row survives if it is valid, writes colour, its
// rect overlaps the strip, and each edge function and each clip plane
// reaches its threshold somewhere on the strip (`edge_reaches`). The z test
// is not in it: the depth is a product of edge values, not a plane.
template <int BW>
__device__ __forceinline__ bool scan_row(const float* row, int n_planes,
                                         const Block<BW>& b) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 q4 = r4[4];
  const float4 q5 = r4[5];
  const int fl = __float2int_rz(q4.y);
  const int bits = __float2int_rz(q5.z);
  if ((fl & 8) == 0 || (bits & 4) == 0 || !(b.sxmax >= q4.z) ||
      !(b.symax >= q4.w) || !(b.sxmin < q5.x) || !(b.symin < q5.y))
    return false;
  const float4 q0 = r4[0];
  const float4 q1 = r4[1];
  bool keep = edge_reaches(q0.x, q0.y, q0.z, (fl & 1) != 0, b.sxmin, b.sxmax,
                           b.symin, b.symax) &&
              edge_reaches(q0.w, q1.x, q1.y, (fl & 2) != 0, b.sxmin, b.sxmax,
                           b.symin, b.symax) &&
              edge_reaches(q1.z, q1.w, row[8], (fl & 4) != 0, b.sxmin,
                           b.sxmax, b.symin, b.symax);
  const float* cp = row + kClip;
  for (int p = 0; p < n_planes && keep; ++p)
    keep = edge_reaches(cp[3 * p], cp[3 * p + 1], cp[3 * p + 2], true,
                        b.sxmin, b.sxmax, b.symin, b.symax);
  return keep;
}

// Coverage of a scanned row on the thread's block, the reference's test:
// the three edges under the top-left rule, esum > 0, 0 <= depth <= 1, the
// per-triangle rect, every user clip plane, the scissor and the z test
// against the opaque plane (the 2-ULP bit window on the equality-inclusive
// compares, in wrapping arithmetic like the reference); the valid and
// colorwrite bits passed the scan. No alpha test. Writes the raw edge
// values. Returns false, with cov unset, when no pixel of the warp passes
// the edges (one `__any_sync`: the whole warp calls): the rest is skipped
// then.
template <int BW>
__device__ __forceinline__ bool cover_block(const float* row, int n_planes,
                                            const Block<BW>& b,
                                            bool (&cov)[BW], float (&e0)[BW],
                                            float (&e1)[BW],
                                            float (&e2)[BW]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 q4 = r4[4];
  const float4 q5 = r4[5];
  // The block against the rect's rows and outer columns first.
  const bool live = b.px[BW - 1] >= q4.z && b.py >= q4.w && b.px[0] < q5.x &&
                    b.py < q5.y;
  const int fl = __float2int_rz(q4.y);
  const float4 q0 = r4[0];
  const float4 q1 = r4[1];
  const float4 q2 = r4[2];
  plane_block(q0.x, q0.y, q0.z, b.px, b.py, e0);
  plane_block(q0.w, q1.x, q1.y, b.px, b.py, e1);
  plane_block(q1.z, q1.w, q2.x, b.px, b.py, e2);
  const float t0 = threshold((fl & 1) != 0);
  const float t1 = threshold((fl & 2) != 0);
  const float t2 = threshold((fl & 4) != 0);
  bool any = false;
#pragma unroll
  for (int k = 0; k < BW; ++k) {
    cov[k] = live && b.sc[k] && e0[k] > t0 && e1[k] > t1 && e2[k] > t2;
    any = any || cov[k];
  }
  // Strips the triangle only comes near leave before esum and depth.
  if (!__any_sync(kFullWarp, any)) return false;

  const float4 q3 = r4[3];
  float es[BW];
  plane_block(q3.y, q3.z, q3.w, b.px, b.py, es);
  const int zf = __float2int_rz(q5.w);
  const bool eq_incl = zf == kLessEqual || zf == kEqual || zf == kGreaterEqual;
#pragma unroll
  for (int k = 0; k < BW; ++k) {
    const float d = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(e0[k], q2.y), __fmul_rn(e1[k], q2.z)),
                  __fmul_rn(e2[k], q2.w)),
        q3.x);
    const int dz = static_cast<int>(static_cast<unsigned>(__float_as_int(d)) -
                                    static_cast<unsigned>(__float_as_int(
                                        b.zb[k])));
    const bool near = (dz >= -2 && dz <= 2) || dz == INT_MIN;
    cov[k] = cov[k] && __fmul_rn(es[k], q4.x) > 0.f && d >= 0.f && d <= 1.f &&
             b.px[k] >= q4.z && b.px[k] < q5.x &&
             (compare(zf, d, b.zb[k]) || (eq_incl && near));
  }
  const float* cp = row + kClip;
  for (int p = 0; p < n_planes; ++p) {
    float dp[BW];
    plane_block(cp[3 * p], cp[3 * p + 1], cp[3 * p + 2], b.px, b.py, dp);
#pragma unroll
    for (int k = 0; k < BW; ++k) cov[k] = cov[k] && dp[k] >= 0.f;
  }
  return true;
}

// Stream the tile's rows [start, start + count) of `rows` (rpitch floats
// each, the first `width` of them staged) through a kStages-deep ring of
// kchunk-row stages, by 16-byte cp.async copies of all THREADS threads.
// Every warp scans each staged chunk 32 rows at a time against its own
// strip (lane l tests row base + l) and hands the survivors to
// group(rows32, todo): rows32 is row `base` in shared memory (rows `width`
// floats apart) and bit l of todo is set for each survivor, so walking the
// bits upwards meets them in stream (draw) order. The call is made by the
// whole warp. A strip's survivors are never shared between warps: the
// callers' carries depend on the order.
template <int THREADS, int BW, typename Group>
__device__ __forceinline__ void walk(float* ring, const float* rows,
                                     int rpitch, int width, int n_planes,
                                     int start, int count, int kchunk,
                                     const Block<BW>& b, Group&& group) {
  const int stage_floats = kchunk * width;
  const int w4 = width >> 2;
  const int chunks = (count + kchunk - 1) / kchunk;
  // Request chunk j into stage j % kStages; always commits a group (an
  // empty one past the end), so the group count stays in step with j.
  auto request = [&](int j) {
    if (j < chunks) {
      const int off = j * kchunk;
      const int n = min(kchunk, count - off);
      const float* src = rows + static_cast<size_t>(start + off) * rpitch;
      float* dst = ring + (j % kStages) * stage_floats;
      for (int i = threadIdx.x; i < n * w4; i += THREADS) {
        const int r = i / w4;
        cp_async16(dst + 4 * i,
                   src + static_cast<size_t>(r) * rpitch + 4 * (i - r * w4));
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) request(j);

  const int lane = threadIdx.x & 31;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();   // this thread's copies of chunk c landed
    __syncthreads();                // everyone's did; chunk c-1 is consumed
    request(c + kStages - 1);       // into the stage chunk c-1 left
    if (!b.strip_live) continue;
    const float* stage = ring + (c % kStages) * stage_floats;
    const int n = min(kchunk, count - c * kchunk);
    for (int base = 0; base < n; base += 32) {
      const bool keep =
          base + lane < n && scan_row(stage + (base + lane) * width, n_planes,
                                      b);
      const unsigned todo = __ballot_sync(kFullWarp, keep);
      if (todo) group(stage + base * width, todo);
    }
  }
}

// The survivors of one scan group, one at a time for the whole warp: for
// each, the block's coverage and, when some pixel of the warp passes the
// edges, visit(row, cov, e0, e1, e2).
template <int BW, typename Visit>
__device__ __forceinline__ void each_survivor(const float* rows32, int width,
                                              unsigned todo, int n_planes,
                                              const Block<BW>& b,
                                              Visit&& visit) {
  while (todo) {
    const float* row = rows32 + (__ffs(todo) - 1) * width;
    todo &= todo - 1;
    bool cov[BW];
    float e0[BW], e1[BW], e2[BW];
    if (cover_block(row, n_planes, b, cov, e0, e1, e2))
      visit(row, cov, e0, e1, e2);
  }
}

}  // namespace ck_ordered
