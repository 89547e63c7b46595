// Tile-binned opaque depth solve, phase B (kernels B1 and B5) for Hopper
// (sm_90a).
//
// Replaces: ckrenderengine_tpu/raster/pallas_tiled.py `_solve_kernel` (with
// its helpers `_group_eval` and `_merge`; entry
// `depth_reduce_tiled_pallas`), the Pallas TPU kernel that streams each
// screen tile's contiguous range of packed triangle rows through VMEM; and,
// as the FETCH instantiation (B5), the same kernel's fused winner-row fetch
// (`sh_w > 0`, `sh_pack = 2`).
//
// What it computes: for each screen tile, a streaming argmin over (1) the
// tile's own range [start, start + count) of the binned row stream, then
// (2) two leftover segments that EVERY tile streams: the unbounded/global
// class and the slab overflow. Coverage needs all of: three edge functions
// under the top-left rule, esum > 0, 0 <= depth <= 1, the per-triangle rect,
// every user clip plane, and the valid bit; the viewport scissor and the
// framebuffer bounds mask the tile's result at the end. The lower depth wins
// and an exact tie goes to the larger triangle id (= the later draw), so the
// result does not depend on the order in which rows reach a pixel, nor on
// rows being skipped that cannot cover it. With WANT_E the winner's raw edge
// values e0/e1/e2 are exported too (the quantized shade consumes them). With
// FETCH (B5) each pixel also receives the quantized shade row of its final
// winner: rows[:, y, x] = shade_tbl[id[y, x], :], int32 words moved bit for
// bit (packed u8 bytes alias NaN and denormal float patterns), 0 where the
// id is -1 (uncovered, or outside the scissor).
//
// What bounds it on the card: instruction rate, and the longest tile. A
// frame at 1024x768 streams some 48 M (pixel, row) pairs past 768 tiles and
// moves ~30 MB (B5: ~80 MB with its row planes). What no exact kernel avoids
// is small: only a pair inside the row's rect that passes all three edge
// tests needs its esum sign and its depth, 15 float operations with the two
// adds of each of the four planes (`fl(fl(a*px + b*py) + c)` in the
// reference's order, so no incremental stepping; the products a*px and b*py
// are shared by a column / a row of pixels), +2 per user clip plane; every
// other pair can in principle be dropped by a test on a whole block. By
// that count the frame's bytes, not its operations, are the roofline, and
// what the kernel spends its time on is finding the few pairs that matter:
// comparisons (top-left rule, ranges, rect, the (depth, id) merge) and the
// edge planes of pairs that then fail, which outnumber the counted
// arithmetic. Rows per tile are few and uneven: at config 5 a tile has 61
// on average and over 500 at most (the horizon), so one CTA per tile leaves
// the longest tile's serial chain as the kernel's time, and three serial,
// unhidden global round trips per tile (the old design) are most of a
// short tile's.
//
// Design.
//  * Rows arrive asynchronously through a ring in shared memory. Phase A
//    lays the stream out with a row pitch that is a multiple of 4 floats
//    (24 for 23 columns; 28 / 32 / 32 with 1 / 2 / 3 clip planes; the pad
//    columns are zeros nothing reads), so every row starts on 16 bytes and
//    a chunk of up to `kchunk` rows of one segment is one contiguous run of
//    16-byte `cp.async.cg` copies made by all threads. The chunks of the
//    three segments form one sequence; kStages = 4 stages, so the first
//    three chunks - for an ordinary tile the whole of its own range and of
//    both leftover segments - are in flight before the first row is
//    evaluated, and a tile pays one memory latency, not three. One
//    `cp.async.wait_group` and one `__syncthreads()` per chunk make the
//    chunk visible and free the stage that is refilled next. `cp.async` was
//    chosen over a 1-D bulk copy (`cp.async.bulk` + `mbarrier`): every
//    thread consumes every row anyway, a chunk is at most 12-16 KB (six
//    copies per thread), `wait_group` needs no phase bookkeeping for tiles
//    that walk the ring zero, one or many times, and it cannot hang.
//  * A 1x4 block of pixels per thread. A row is read as 16-byte shared
//    loads that serve all four pixels; b*py is computed once per plane,
//    flags and id are converted once per row; the top-left rule is one
//    comparison per edge and pixel (e > 0 or e > -denorm_min, which is
//    e >= 0: the library is built without flush-to-zero). The carry
//    (depth, id[, e0, e1, e2]) of the four pixels stays in registers.
//  * A CTA per 16x16 sub-tile (a quadrant of a 32x32 tile), not per tile:
//    the four quadrants copy the same rows (from L2) and run on different
//    SMs, which divides the longest tile's chain by its pixels. A CTA is
//    kGroups = 2 groups of 64 threads; each group covers the whole
//    sub-tile, a warp a 16x8 strip.
//  * Rejects before the arithmetic, all exact (they only drop pairs the
//    full test would reject). Scan: 32 rows at a time, lane l tests row l
//    against the warp's whole strip: valid bit, rect overlap, and for each
//    edge whether its function reaches the threshold anywhere on the strip.
//    Rounded products and sums are monotone in px and py, so the greatest
//    value over the strip is the value at one corner, computed with the
//    reference's own operations (`edge_reaches`). A ballot leaves the
//    survivors (about four rows in ten at config 5); the warps of the two
//    groups that share a strip take them in turns, so a strip's chain is
//    halved again. For a survivor each thread tests its own block against
//    the row's rect first (four comparisons), evaluates the three edge
//    planes, and one `__any_sync` lets strips the triangle only comes near
//    leave before esum, depth and the merge.
//  * Epilogue: the groups' carries meet in shared memory (the idle ring);
//    then a pixel per thread and pass: merge by the same (depth, id) rule,
//    scissor, and scalar stores in which a warp fills whole 64-byte runs of
//    two pixel rows (two full 32-byte sectors each; a quadrant is 16 wide,
//    so a 128-byte line is shared with the neighbouring quadrant). B5
//    loads its pixel's table row with 16-byte `__ldg` loads (neighbours
//    mostly share a winner) and stores the words channel-major the same
//    way. Every global load but the rows (ranges, viewport, initial
//    depths) is started in the prologue, under the first copies.
//
// Tried on the card and dropped (config 5's shapes, B1 with e-planes,
// kernel time from torch.profiler, NVIDIA H100 80GB HBM3, 700 W; the kept
// design 0.046 ms, the one-thread-per-pixel kernel it replaces 0.265 ms):
// one CTA of 256 threads per 32x32 tile with a vote after every edge plane
// and no scan, 0.154 ms, with one vote 0.140 ms, with the scan 0.092 ms
// (the 558-row tile alone ran 77 of those 92 us); a 2x4 block per thread,
// 0.215 against 0.154 ms (127 registers, half the warps); sub-tiles of 32x8
// (a warp's stores fill 128-byte lines, but a 32x4 strip keeps more false
// survivors than a 16x8 one), 0.061 ms; four groups per sub-tile, 0.052
// ms, one group 0.062 ms, eight 0.096 ms; 64-row chunks, and 5, 6 or 8
// CTAs per SM by `__launch_bounds__`: within 5% of the kept setting or
// worse; 3 stages: B1 the same, B5 7% faster (a smaller ring, more CTAs
// under its stores), not taken because then only two chunks are in flight
// before the first row. A persistent grid was not tried: after the split
// the longest CTA and the sum over all CTAs end within 10% of each other.
//
// Nothing is carried over from the Pallas kernel's block structure (8-row
// DMA alignment, shift prefetch, 128-lane rows, (8, npix) outputs, two
// chunks per grid step).
//
// Numerics: edge, esum, depth and clip-plane values use explicit
// round-to-nearest multiplies and adds in the reference's order of
// operations (no FMA contraction; the library is also built with
// --fmad=false), so winners, depths, e-values and rows equal the plain torch
// version bit for bit.

#include <cuda_runtime.h>

#include "tile_scan.cuh"

namespace {

using namespace ck_tile;

// Packed-row column layout (raster/tiled.py _C_*), read as float4 quads:
//   q0 = e0.a e0.b e0.c e1.a     q1 = e1.b e1.c e2.a e2.b
//   q2 = e2.c z0 z1 z2           q3 = inv_det_s esum.a esum.b esum.c
//   q4 = s flags rect.x0 rect.y0 q5 = rect.x1 rect.y1 id (pad | plane 0 a)
constexpr int kNcol = 23;        // + 3 per user clip plane
constexpr int kStages = 4;       // ring stages
constexpr int kBW = 4;           // pixels per thread: a 1 x kBW block
constexpr int kSub = 16;         // a CTA's sub-tile: kSub x kSub pixels
constexpr int kSubPixels = kSub * kSub;
constexpr int kGroupThreads = kSubPixels / kBW;   // 64: two warps
constexpr int kGroups = 2;       // warp groups that share out the rows
constexpr int kThreads = kGroupThreads * kGroups;
constexpr unsigned kFullWarp = 0xffffffffu;

struct TileStream {
  int start0, count0, chunks0;   // the tile's own range
  int start1, count1, chunks1;   // global class
  int start2, count2;            // slab overflow
  int total;                     // chunks of all three
  int kchunk;

  // First stream row and row count of chunk j of the sequence.
  __device__ __forceinline__ void chunk(int j, int& first, int& n) const {
    int base = start0, cnt = count0;
    if (j >= chunks0 + chunks1) {
      j -= chunks0 + chunks1;
      base = start2;
      cnt = count2;
    } else if (j >= chunks0) {
      j -= chunks0;
      base = start1;
      cnt = count1;
    }
    const int off = j * kchunk;
    first = base + off;
    n = min(kchunk, cnt - off);
  }
};

template <bool WANT_E, bool FETCH>
__global__ void __launch_bounds__(kThreads, 4) solve_tiled_kernel(
    const float* __restrict__ rows, int rpitch, int n_planes,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ leftn, int gbase, int sbase,
    const float* __restrict__ viewport, float fwidth, float fheight,
    float row0, const float* __restrict__ init_d, float* __restrict__ out_d,
    int* __restrict__ out_i, float* __restrict__ out_e,
    const int* __restrict__ shade_tbl, int sh_w, int n_tris,
    int* __restrict__ out_rows, int tile, int tiles_x, int pitch,
    int plane_size, int kchunk) {
  extern __shared__ float4 ring4[];
  float* const ring = reinterpret_cast<float*>(ring4);
  const int stage_floats = kchunk * rpitch;
  // A CTA owns a kSub x kSub sub-tile: a quadrant of a 32x32 tile, the
  // whole of a 16x16 one.
  const int subs_x = tile / kSub;
  const int subs = subs_x * subs_x;
  const int t = blockIdx.x / subs;
  const int sub = blockIdx.x - t * subs;

  // Every global load the CTA needs besides the rows starts here, so
  // they share one memory latency: the ranges, the viewport and (below) the
  // initial depths of the block and of the epilogue's pixels.
  const float vx0 = __ldg(viewport);
  const float vy0 = __ldg(viewport + 1);
  const float vw = __ldg(viewport + 2);
  const float vh = __ldg(viewport + 3);
  TileStream ts;
  ts.kchunk = kchunk;
  ts.start0 = starts[t];
  ts.count0 = counts[t];
  ts.start1 = gbase;
  ts.count1 = leftn[0];
  ts.start2 = sbase;
  ts.count2 = leftn[1];
  ts.chunks0 = (ts.count0 + kchunk - 1) / kchunk;
  ts.chunks1 = (ts.count1 + kchunk - 1) / kchunk;
  ts.total = ts.chunks0 + ts.chunks1 + (ts.count2 + kchunk - 1) / kchunk;

  // Request chunk j into stage j % kStages; always commits a group (an
  // empty one past the end), so the group count stays in step with j.
  auto request = [&](int j) {
    if (j < ts.total) {
      int first, n;
      ts.chunk(j, first, n);
      const float* src = rows + static_cast<size_t>(first) * rpitch;
      float* dst = ring + (j % kStages) * stage_floats;
      const int nvec = n * (rpitch >> 2);
      for (int i = threadIdx.x; i < nvec; i += kThreads)
        cp_async16(dst + 4 * i, src + 4 * i);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) request(j);

  // The thread's pixel block, while the first chunks are in flight. The
  // kGroups warp groups all cover the whole sub-tile, block b of a group
  // row-major over it.
  const int ty = t / tiles_x;
  const int tx = t - ty * tiles_x;
  const int x0 = tx * tile + (sub % subs_x) * kSub;
  const int y0 = ty * tile + (sub / subs_x) * kSub;
  const int group = threadIdx.x / kGroupThreads;
  const int b = threadIdx.x - group * kGroupThreads;
  constexpr int kBlockCols = kSub / kBW;
  const int brow = b / kBlockCols;
  const int bx = (b % kBlockCols) * kBW;
  float px[kBW];
#pragma unroll
  for (int k = 0; k < kBW; ++k)
    px[k] = static_cast<float>(x0 + bx + k) + 0.5f;
  // Rows at their global centres (a band of a frame starts at row0).
  const float py = centre(y0 + brow, row0);
  const float pxmin = px[0], pxmax = px[kBW - 1];

  float bd[kBW], b0[kBW], b1[kBW], b2[kBW];
  int bi[kBW];
  {
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        init_d + (y0 + brow) * pitch + x0 + bx));
    bd[0] = v.x;
    bd[1] = v.y;
    bd[2] = v.z;
    bd[3] = v.w;
#pragma unroll
    for (int k = 0; k < kBW; ++k) {
      bi[k] = -1;
      b0[k] = b1[k] = b2[k] = 0.f;
    }
  }

  // Initial depths of the pixels this thread finishes in the epilogue.
  float init_p[kSubPixels / kThreads];
#pragma unroll
  for (int i = 0; i < kSubPixels / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    init_p[i] = __ldg(init_d + (y0 + p / kSub) * pitch + x0 + p % kSub);
  }

  // The warp's pixel strip, 16x8 pixels: a warp holds 32 consecutive
  // blocks, eight whole block rows, so lane 0 has the strip's least pixel
  // centre in x and y and lane 31 its greatest.
  const int lane = threadIdx.x & 31;
  const float sxmin = __shfl_sync(kFullWarp, pxmin, 0);
  const float symin = __shfl_sync(kFullWarp, py, 0);
  const float sxmax = __shfl_sync(kFullWarp, pxmax, 31);
  const float symax = __shfl_sync(kFullWarp, py, 31);

  const int rp4 = rpitch >> 2;
  int turn = 0;   // survivors of this strip so far, modulo kGroups
  for (int c = 0; c < ts.total; ++c) {
    cp_async_wait<kStages - 2>();   // this thread's copies of chunk c landed
    __syncthreads();                // everyone's did; chunk c-1 is consumed
    request(c + kStages - 1);       // into the stage chunk c-1 left
    int first, n;
    ts.chunk(c, first, n);
    const float4* stage =
        reinterpret_cast<const float4*>(ring + (c % kStages) * stage_floats);
    for (int base = 0; base < n; base += 32) {
      // Scan: lane l holds row base + l against the whole strip. The row
      // survives only if it is valid, its rect overlaps the strip and each
      // edge function reaches its threshold somewhere on the strip.
      bool keep = false;
      if (base + lane < n) {
        const float4* row = stage + (base + lane) * rp4;
        const float4 q4 = row[4];
        const float4 q5 = row[5];
        const int fl = __float2int_rz(q4.y);
        if ((fl & 8) != 0 && sxmax >= q4.z && symax >= q4.w &&
            sxmin < q5.x && symin < q5.y) {
          const float4 q0 = row[0];
          const float4 q1 = row[1];
          const float c2 = row[2].x;
          keep = edge_reaches(q0.x, q0.y, q0.z, (fl & 1) != 0, sxmin, sxmax,
                              symin, symax) &&
                 edge_reaches(q0.w, q1.x, q1.y, (fl & 2) != 0, sxmin, sxmax,
                              symin, symax) &&
                 edge_reaches(q1.z, q1.w, c2, (fl & 4) != 0, sxmin, sxmax,
                              symin, symax);
        }
      }
      // The groups that share this strip see the same survivors and take
      // them in turns.
      unsigned todo = __ballot_sync(kFullWarp, keep);
      while (todo) {
        const int r = base + __ffs(todo) - 1;
        todo &= todo - 1;
        const bool mine = turn == group;
        turn = (turn + 1) & (kGroups - 1);
        if (!mine) continue;
        const float4* row = stage + r * rp4;
        const float4 q4 = row[4];
        const float4 q5 = row[5];
        // The block against the row's rect, before any plane: four
        // comparisons (the row's rect overlaps the strip, not every block).
        const bool live = pxmax >= q4.z && py >= q4.w && pxmin < q5.x &&
                          py < q5.y;
        const int fl = __float2int_rz(q4.y);
        const float4 q0 = row[0];
        const float4 q1 = row[1];
        const float4 q2 = row[2];
        float e0[kBW], e1[kBW], e2[kBW];
        plane_block(q0.x, q0.y, q0.z, px, py, e0);
        plane_block(q0.w, q1.x, q1.y, px, py, e1);
        plane_block(q1.z, q1.w, q2.x, px, py, e2);
        const float t0 = threshold((fl & 1) != 0);
        const float t1 = threshold((fl & 2) != 0);
        const float t2 = threshold((fl & 4) != 0);
        bool cov[kBW];
        bool any = false;
#pragma unroll
        for (int k = 0; k < kBW; ++k) {
          cov[k] = live && e0[k] > t0 && e1[k] > t1 && e2[k] > t2;
          any = any || cov[k];
        }
        // Strips the triangle only comes near leave before esum and depth.
        if (!__any_sync(kFullWarp, any)) continue;

        const float4 q3 = row[3];
        float es[kBW], depth[kBW];
        plane_block(q3.y, q3.z, q3.w, px, py, es);
#pragma unroll
        for (int k = 0; k < kBW; ++k) {
          const float d = __fmul_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(e0[k], q2.y),
                                  __fmul_rn(e1[k], q2.z)),
                        __fmul_rn(e2[k], q2.w)),
              q3.x);
          depth[k] = d;
          cov[k] = cov[k] && __fmul_rn(es[k], q4.x) > 0.f && d >= 0.f &&
                   d <= 1.f && px[k] >= q4.z && px[k] < q5.x;
        }
        if (n_planes > 0) {
          const float* cp = reinterpret_cast<const float*>(row) + kNcol;
          for (int p = 0; p < n_planes; ++p) {
            float dp[kBW];
            plane_block(cp[3 * p], cp[3 * p + 1], cp[3 * p + 2], px, py, dp);
#pragma unroll
            for (int k = 0; k < kBW; ++k) cov[k] = cov[k] && dp[k] >= 0.f;
          }
        }
        const int id = __float2int_rz(q5.z);
#pragma unroll
        for (int k = 0; k < kBW; ++k) {
          const float d = depth[k];
          if (cov[k] && (d < bd[k] || (d == bd[k] && id > bi[k]))) {
            bd[k] = d;
            bi[k] = id;
            if (WANT_E) {
              b0[k] = e0[k];
              b1[k] = e1[k];
              b2[k] = e2[k];
            }
          }
        }
      }
    }
  }

  // Merge the groups' carries through shared memory (the ring is idle: every
  // chunk that was requested has been waited for and consumed). Field f of
  // group g lies at [(g * kFields + f) * kSubPixels + pixel].
  constexpr int kFields = WANT_E ? 5 : 2;
  __syncthreads();
  {
    float* mine = ring + group * kFields * kSubPixels + brow * kSub + bx;
    *reinterpret_cast<float4*>(mine) = make_float4(bd[0], bd[1], bd[2], bd[3]);
    *reinterpret_cast<int4*>(mine + kSubPixels) =
        make_int4(bi[0], bi[1], bi[2], bi[3]);
    if (WANT_E) {
      *reinterpret_cast<float4*>(mine + 2 * kSubPixels) =
          make_float4(b0[0], b0[1], b0[2], b0[3]);
      *reinterpret_cast<float4*>(mine + 3 * kSubPixels) =
          make_float4(b1[0], b1[1], b1[2], b1[3]);
      *reinterpret_cast<float4*>(mine + 4 * kSubPixels) =
          make_float4(b2[0], b2[1], b2[2], b2[3]);
    }
  }
  __syncthreads();

  // Epilogue, a pixel per thread and pass: a warp finishes two 16-pixel
  // rows of the sub-tile, so each of its stores to a plane fills two whole
  // 64-byte runs (four 32-byte sectors).
  const float vx1 = __fadd_rn(vx0, vw);
  const float vy1 = __fadd_rn(vy0, vh);
#pragma unroll
  for (int i = 0; i < kSubPixels / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int gx = x0 + p % kSub;
    const int gy = y0 + p / kSub;
    const int pix = gy * pitch + gx;
    float wd = ring[p];
    int wi = __float_as_int(ring[kSubPixels + p]);
    int wg = 0;
#pragma unroll
    for (int g = 1; g < kGroups; ++g) {
      const float d = ring[g * kFields * kSubPixels + p];
      const int id = __float_as_int(ring[(g * kFields + 1) * kSubPixels + p]);
      if (d < wd || (d == wd && id > wi)) {
        wd = d;
        wi = id;
        wg = g;
      }
    }
    const float fx = static_cast<float>(gx) + 0.5f;
    const float fy = centre(gy, row0);
    // The viewport in global rows, the framebuffer bounds in local ones.
    const bool scissor = fx >= vx0 && fx < vx1 && fy >= vy0 && fy < vy1 &&
                         fx < fwidth &&
                         static_cast<float>(gy) + 0.5f < fheight;
    out_d[pix] = scissor ? wd : init_p[i];
    const int id = scissor ? wi : -1;
    out_i[pix] = id;
    if (WANT_E) {
      const float* we = ring + (wg * kFields + 2) * kSubPixels + p;
      out_e[pix] = scissor ? we[0] : 0.f;
      out_e[plane_size + pix] = scissor ? we[kSubPixels] : 0.f;
      out_e[2 * static_cast<size_t>(plane_size) + pix] =
          scissor ? we[2 * kSubPixels] : 0.f;
    }
    if (FETCH) {
      // Winner ids are < n_tris by construction; the bound keeps a corrupt
      // stream from reading outside the table.
      const bool hit = id >= 0 && id < n_tris;
      const int4* src = reinterpret_cast<const int4*>(
          shade_tbl + static_cast<size_t>(hit ? id : 0) * sh_w);
      int* dst = out_rows + pix;
      for (int c = 0; c < sh_w; c += 4) {
        int4 v = make_int4(0, 0, 0, 0);
        if (hit) v = __ldg(src + (c >> 2));
        dst[static_cast<size_t>(c) * plane_size] = v.x;
        dst[static_cast<size_t>(c + 1) * plane_size] = v.y;
        dst[static_cast<size_t>(c + 2) * plane_size] = v.z;
        dst[static_cast<size_t>(c + 3) * plane_size] = v.w;
      }
    }
  }
}

struct Geometry {
  dim3 grid, block;
  size_t smem;
  int pitch, plane_size;
};

// Launch geometry, or false when the kernel does not take the shapes: a
// tile must split into whole sub-tiles whose block rows fill whole warps
// (16 or 32 pixels wide), and the row pitch must keep every row on 16
// bytes and hold the six quads the kernel reads.
bool geometry(int ncol, int rpitch, int n_planes, int tile, int tiles_x,
              int tiles_y, int kchunk, bool want_e, Geometry* g) {
  if ((tile != 16 && tile != 32) || kchunk <= 0 || n_planes < 0 ||
      ncol != kNcol + 3 * n_planes || rpitch < ncol || rpitch < 24 ||
      (rpitch & 3))
    return false;
  const size_t ring = static_cast<size_t>(kStages) * kchunk * rpitch;
  const size_t merge = static_cast<size_t>(kGroups) * (want_e ? 5 : 2) *
                       kSubPixels;
  g->grid = dim3(tiles_x * tiles_y * (tile * tile / kSubPixels));
  g->block = dim3(kThreads);
  g->smem = (ring > merge ? ring : merge) * sizeof(float);
  g->pitch = tiles_x * tile;
  g->plane_size = g->pitch * tiles_y * tile;
  return true;
}

template <bool WANT_E, bool FETCH>
cudaError_t launch(const Geometry& g, cudaStream_t s, const float* rows,
                   int rpitch, int n_planes, const int* starts,
                   const int* counts, const int* leftn, int gbase, int sbase,
                   const float* viewport, int width, int height, float row0,
                   const float* init_d, float* out_d, int* out_i, float* out_e,
                   const int* shade_tbl, int sh_w, int n_tris, int* out_rows,
                   int tile, int tiles_x, int kchunk) {
  cudaError_t err = cudaFuncSetAttribute(
      solve_tiled_kernel<WANT_E, FETCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  solve_tiled_kernel<WANT_E, FETCH><<<g.grid, g.block, g.smem, s>>>(
      rows, rpitch, n_planes, starts, counts, leftn, gbase, sbase, viewport,
      static_cast<float>(width), static_cast<float>(height), row0, init_d,
      out_d, out_i, out_e, shade_tbl, sh_w, n_tris, out_rows, tile, tiles_x,
      g.pitch, g.plane_size, kchunk);
  return cudaGetLastError();
}

template <bool WANT_E, bool FETCH>
int occupancy(const Geometry& g) {
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      solve_tiled_kernel<WANT_E, FETCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, solve_tiled_kernel<WANT_E, FETCH>,
        static_cast<int>(g.block.x), g.smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// `rows` is the (n, rpitch) stream, rpitch a multiple of 4 floats and `rows`
// 16-byte aligned; `ncol` = 23 + 3 * n_planes of its columns are read.
// `row0`: the global row of the frame's first row (a band of a frame; 0 for
// a whole frame): pixel centres are fl(fl(y + 0.5) + row0), the viewport is
// in global rows, `height` bounds the local ones. `out_e` null: no e-planes. `shade_tbl` null: B1; else B5, which fetches
// the (n_tris, sh_w) int32 table's winner rows into `out_rows`
// (sh_w, H_pad, W_pad); sh_w must be a multiple of 4 and the table 16-byte
// aligned.
extern "C" int ck_solve_tiled(
    const float* rows, int ncol, int rpitch, int n_planes, const int* starts,
    const int* counts, const int* leftn, int gbase, int sbase,
    const float* viewport, int width, int height, float row0,
    const float* init_d, float* out_d, int* out_i, float* out_e,
    const int* shade_tbl, int sh_w, int n_tris, int* out_rows, int tile,
    int tiles_x, int tiles_y, int kchunk, void* stream) {
  Geometry g;
  if (!geometry(ncol, rpitch, n_planes, tile, tiles_x, tiles_y, kchunk,
                out_e != nullptr, &g) ||
      (reinterpret_cast<size_t>(rows) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool want_e = out_e != nullptr;
  const bool fetch = shade_tbl != nullptr;
  if (fetch && ((sh_w & 3) != 0 || out_rows == nullptr ||
                (reinterpret_cast<size_t>(shade_tbl) & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
#define CK_SOLVE_ARGS                                                       \
  g, s, rows, rpitch, n_planes, starts, counts, leftn, gbase, sbase,        \
      viewport, width, height, row0, init_d, out_d, out_i, out_e,           \
      shade_tbl, sh_w, n_tris, out_rows, tile, tiles_x, kchunk
  cudaError_t err;
  if (fetch)
    err = want_e ? launch<true, true>(CK_SOLVE_ARGS)
                 : launch<false, true>(CK_SOLVE_ARGS);
  else
    err = want_e ? launch<true, false>(CK_SOLVE_ARGS)
                 : launch<false, false>(CK_SOLVE_ARGS);
#undef CK_SOLVE_ARGS
  return static_cast<int>(err);
}

// Resident CTAs per SM of one instantiation at a launch's shapes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a negative CUDA error
// code when the shapes are not taken.
extern "C" int ck_solve_tiled_occupancy(int want_e, int fetch, int n_planes,
                                        int rpitch, int tile, int kchunk) {
  Geometry g;
  if (!geometry(kNcol + 3 * n_planes, rpitch, n_planes, tile, 1, 1, kchunk,
                want_e != 0, &g))
    return -static_cast<int>(cudaErrorInvalidValue);
  if (fetch)
    return want_e ? occupancy<true, true>(g) : occupancy<false, true>(g);
  return want_e ? occupancy<true, false>(g) : occupancy<false, false>(g);
}
