// Flat opaque depth solve (kernel B2) for Hopper (sm_90a).
//
// Replaces: ckrenderengine_tpu/raster/pallas_reduce.py `_kernel` (entry
// `depth_reduce_pallas`), the Pallas TPU kernel that keeps the (H, W)
// depth/id carry in VMEM while the grid walks 16-triangle chunks.
//
// What it computes: for every pixel, the argmin over ALL T packed triangle
// rows (pack_rows layout, 32 floats per row) of the triangle depth, with the
// reference's LESSEQUAL rule in draw order: an exact tie goes to the later
// draw. The initial carry is (clear_z, -1). Coverage: three edge functions
// under the top-left fill rule, esum > 0, 0 <= depth <= 1, the viewport
// scissor, the valid bit and the per-triangle rect (no user clip planes: the
// frame routes those to the tiled solve).
//
// What bounds it on the card: bytes, by the repo's roofline count (chip_smoke
// `roofline`): the rows at the seven 16-byte words the kernel reads and the
// two planes it writes (at config 1, 128 rows and 256x256 pixels: 0.54 MB,
// 0.00016 ms at 3.35 TB/s). Besides, a pair whose pixel passes valid, rect
// and all three edges needs its esum and depth: 15 operations, which bound a
// flat frame of large triangles (128 rows covering 640x480: 0.0176 ms). The
// frame pads the triangle count to a multiple of 128, and a flat frame
// (T <= 4096, T*H*W <= 2^26) may hold thousands of rows that each reach a few
// pixels, so most of the work is finding the few pairs that matter. The
// one-thread-per-pixel kernel this replaces evaluated all T*H*W pairs: at
// config 1, 8.4 M pairs of which 12,262 pass rect and edges, 0.0254 ms on an
// NVIDIA H100 80GB HBM3 at 700 W whether the rows were valid or not (so not
// launch latency, but padding rows and rows that miss the pixel).
//
// Design (the tiled solve's pieces from tile_scan.cuh, on B2's row layout).
//  * A CTA per 16x16 sub-tile, 64 threads, a 1x4 block of pixels per thread
//    with the (depth, id) carry of the four pixels in registers; a warp
//    covers a 16x8 strip.
//  * Every CTA streams the same rows (from L2: 128 KB at the 1,024 rows of
//    a full 256x256 flat frame) through a 4-stage ring in shared memory, 32
//    rows per stage, by 16-byte `cp.async.cg` copies of the seven words that
//    hold fields 0-27 (26 are used). In shared memory a row takes 28 floats:
//    lanes that read the same word of eight consecutive rows hit 32
//    different banks. Three stages are in flight before the first row is
//    tested; then one `cp.async.wait_group` and one `__syncthreads()` per
//    stage, and the stage consumed last is refilled.
//  * The exact strip scan: lane l tests row l of the stage against its
//    warp's strip (clipped to the frame): the valid bit, the rect overlap,
//    then for each edge `edge_reaches` with the row's top-left flag: the
//    greatest rounded plane value over the strip's pixel centres sits at the
//    corner the signs of (a, b) pick, since rounded products and sums are
//    monotone, so no row that could cover a pixel of the strip is dropped. A
//    ballot leaves the survivors in draw order, and only those are
//    evaluated: each thread tests its block against the rect, computes the
//    three edge planes (b*py once per plane), and one `__any_sync` lets
//    strips the triangle only comes near leave before esum and depth. A
//    thread sees its rows in draw order, so `depth <= carry` is the
//    reference's rule itself. Padding rows, back faces and rows far from
//    the strip cost a lane's test in one scan round each.
//  * Few sub-tiles, many rows: a frame with fewer sub-tiles than twice the
//    SMs splits the rows over a thread block cluster of 2, 4 or 8 CTAs on
//    the same sub-tile, while each keeps at least four stages of rows. Each
//    CTA walks a contiguous range of rows and leaves its carry in its shared
//    memory; after a cluster barrier every CTA merges a share of the
//    sub-tile's pixels from all ranks' carries through distributed shared
//    memory. Row ids are the draw order, so the merge is the order-free
//    form of the rule: the lower depth wins and an equal one (compared as
//    floats, so -0.0 ties +0.0, as `<=` has it) goes to the larger id; no
//    integer key, which would order -0.0 below +0.0. At 128x128 with 4,096
//    rows (64 sub-tiles for 132 SMs) that is 512 CTAs of 512 rows each:
//    0.0186 ms, where one CTA per sub-tile took 0.0852 (a 16x8 sub-tile
//    would have halved the chain once, the cluster of 8 divides it by 8).
//  * A sub-tile whose pixel centres lie wholly outside the viewport scissor
//    writes the clear carry (clear_z, -1) and does no scan. Otherwise the
//    epilogue masks each pixel by the scissor and the frame bounds, a pixel
//    per thread and pass, so a warp's stores fill whole 64-byte runs of two
//    pixel rows.
//
// Measured (B2's own time under torch.profiler, `frame_bench.py --flat`,
// NVIDIA H100 80GB HBM3, 700 W): config 1's shape 0.0053 ms; the same
// launch with every row invalid 0.0050, with no rows 0.0020 (the grid and
// its two planes), so what is left at config 1 is the grid and the round
// trips of the rows' stages. Where every row reaches every strip (128 rows
// over 640x480, 0.085 ms) the survivor loop (`cuobjdump -sass` of the built
// library) is about 150 instructions per row and warp, 37 per pixel-row
// pair: the 15 counted operations and the comparisons and selects of
// coverage, range, rect and carry. Instruction issue holds it there.
//
// Tried as one-change variants (same tool and card; ms at config 1's shape
// / flat_limit_256 / flat_deep_640 / flat_cap_128, against 0.0056 / 0.0175
// / 0.0839 / 0.0186 for this design with all four stages requested before
// the first row, itself 0.0052 / 0.0164 / 0.0843 / 0.0182 with three, as
// kept): no cluster split, flat_cap_128 0.0852 and flat_limit_256 0.0200;
// a split as soon as each rank keeps two stages, config 1 0.0060 and its
// floor 0.0058 against 0.0048; 6 stages, level; the order-free rule inside
// a thread, 0.0058 / 0.0175 / 0.0881 / 0.0197; two warp groups per CTA that
// take the survivors in turns (as in the tiled solve; 128 threads, 7 CTAs
// per SM), 0.0054 / 0.0175 / 0.0837 / 0.0194: level but for config 1's
// shorter epilogue, not worth a second merge level.
//
// Nothing is carried over from the Pallas kernel's block structure (16-row
// chunks, (64, W) row blocks, lane-wide rows).
//
// Numerics: each edge, esum and depth value is computed with explicit
// round-to-nearest multiplies and adds in the reference's order of
// operations (no FMA contraction; the library is also built with
// --fmad=false and without flush-to-zero), so results equal the plain torch
// version bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tile_scan.cuh"

namespace {

using namespace ck_tile;
namespace cg = cooperative_groups;

// pack_rows layout, read as the float4 words q0..q6 of a row:
//   q0 = e0.a e0.b e0.c e1.a        q1 = e1.b e1.c e2.a e2.b
//   q2 = e2.c tl0 tl1 tl2           q3 = z0 z1 z2 inv_det_s
//   q4 = esum.a esum.b esum.c s     q5 = valid x0 y0 x1
//   q6 = y1 id (pad) (pad)
constexpr int kRow = 32;           // floats per packed row in device memory
constexpr int kWords = 7;          // 16-byte words of a row the kernel reads
constexpr int kPitch = 4 * kWords; // floats per row in shared memory
constexpr int kChunk = 32;         // rows per ring stage: one scan round
constexpr int kStages = 4;
constexpr int kStageFloats = kChunk * kPitch;
constexpr int kBW = 4;             // pixels per thread: a 1 x kBW block
constexpr int kSub = 16;           // a CTA's sub-tile: kSub x kSub pixels
constexpr int kSubPixels = kSub * kSub;
constexpr int kThreads = kSubPixels / kBW;   // 64: two warps
constexpr int kBlockCols = kSub / kBW;
constexpr int kMaxSplit = 8;       // CTAs of a cluster (the portable limit)
constexpr unsigned kFullWarp = 0xffffffffu;

__global__ void __launch_bounds__(kThreads, 8) reduce_flat_kernel(
    const float* __restrict__ rows, int t, int per, int split,
    const float* __restrict__ view5, float* __restrict__ best_d,
    int* __restrict__ best_i, int height, int width, float row0,
    int subs_x) {
  __shared__ __align__(16) float ring[kStages * kStageFloats];
  // A cluster's CTAs are consecutive blocks on one sub-tile; rank r walks
  // rows [r * per, (r + 1) * per).
  const int rank = blockIdx.x % split;
  const int sub = blockIdx.x / split;
  const int r0 = min(t, rank * per);
  const int r1 = min(t, r0 + per);
  const int total = (r1 - r0 + kChunk - 1) / kChunk;

  // Request chunk j into stage j % kStages; always commits a group (an
  // empty one past the end), so the group count stays in step with j.
  auto request = [&](int j) {
    if (j < total) {
      const int first = r0 + j * kChunk;
      const int n = min(kChunk, r1 - first);
      const float* src = rows + static_cast<size_t>(first) * kRow;
      float* dst = ring + (j % kStages) * kStageFloats;
      for (int i = threadIdx.x; i < n * kWords; i += kThreads) {
        const int r = i / kWords;
        const int w = i - r * kWords;
        cp_async16(dst + r * kPitch + 4 * w, src + r * kRow + 4 * w);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) request(j);

  // Everything else while the first stages are in flight.
  const float vx0 = __ldg(view5);
  const float vy0 = __ldg(view5 + 1);
  const float vx1 = __fadd_rn(vx0, __ldg(view5 + 2));
  const float vy1 = __fadd_rn(vy0, __ldg(view5 + 3));
  const float clear = __ldg(view5 + 4);
  const int x0 = (sub % subs_x) * kSub;
  const int y0 = (sub / subs_x) * kSub;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int brow = threadIdx.x / kBlockCols;
  const int bx = (threadIdx.x % kBlockCols) * kBW;
  float px[kBW];
#pragma unroll
  for (int k = 0; k < kBW; ++k)
    px[k] = static_cast<float>(x0 + bx + k) + 0.5f;
  // Rows at their global centres (a band of a frame starts at row0): the
  // strip's bounds below too, or the scan would drop rows that cover it.
  const float py = centre(y0 + brow, row0);
  const float pxmin = px[0], pxmax = px[kBW - 1];
  // The warp's 16x8 strip, clipped to the frame: rows that reach only
  // pixels nobody writes are dropped too.
  const int sy0 = y0 + warp * (kSub / 2);
  const bool strip_live = sy0 < height;
  const float sxmin = static_cast<float>(x0) + 0.5f;
  const float sxmax = static_cast<float>(min(x0 + kSub, width) - 1) + 0.5f;
  const float symin = centre(sy0, row0);
  const float symax = centre(min(sy0 + kSub / 2, height) - 1, row0);
  // No pixel centre of the sub-tile passes the scissor: a sufficient test.
  const float tx1 = static_cast<float>(x0 + kSub - 1) + 0.5f;
  const float ty1 = centre(y0 + kSub - 1, row0);
  const bool outside = tx1 < vx0 || sxmin >= vx1 || ty1 < vy0 ||
                       centre(y0, row0) >= vy1;

  float bd[kBW];
  int bi[kBW];
#pragma unroll
  for (int k = 0; k < kBW; ++k) {
    bd[k] = clear;
    bi[k] = -1;
  }

  for (int c = 0; c < total && !outside; ++c) {
    cp_async_wait<kStages - 2>();   // this thread's copies of chunk c landed
    __syncthreads();                // everyone's did; chunk c-1 is consumed
    request(c + kStages - 1);       // into the stage chunk c-1 left
    if (!strip_live) continue;
    const int n = min(kChunk, r1 - r0 - c * kChunk);
    const float4* stage =
        reinterpret_cast<const float4*>(ring + (c % kStages) * kStageFloats);
    // Scan: lane l holds row l against the whole strip.
    bool keep = false;
    if (lane < n) {
      const float4* row = stage + lane * kWords;
      const float4 q5 = row[5];
      const float4 q6 = row[6];
      if (q5.x > 0.f && sxmax >= q5.y && symax >= q5.z && sxmin < q5.w &&
          symin < q6.x) {
        const float4 q0 = row[0];
        const float4 q1 = row[1];
        const float4 q2 = row[2];
        keep = edge_reaches(q0.x, q0.y, q0.z, q2.y > 0.f, sxmin, sxmax,
                            symin, symax) &&
               edge_reaches(q0.w, q1.x, q1.y, q2.z > 0.f, sxmin, sxmax,
                            symin, symax) &&
               edge_reaches(q1.z, q1.w, q2.x, q2.w > 0.f, sxmin, sxmax,
                            symin, symax);
      }
    }
    unsigned todo = __ballot_sync(kFullWarp, keep);
    while (todo) {
      const float4* row = stage + (__ffs(todo) - 1) * kWords;
      todo &= todo - 1;
      const float4 q5 = row[5];
      const float4 q6 = row[6];
      // The block against the row's rect, before any plane.
      const bool live = pxmax >= q5.y && py >= q5.z && pxmin < q5.w &&
                        py < q6.x;
      const float4 q0 = row[0];
      const float4 q1 = row[1];
      const float4 q2 = row[2];
      float e0[kBW], e1[kBW], e2[kBW];
      plane_block(q0.x, q0.y, q0.z, px, py, e0);
      plane_block(q0.w, q1.x, q1.y, px, py, e1);
      plane_block(q1.z, q1.w, q2.x, px, py, e2);
      const float t0 = threshold(q2.y > 0.f);
      const float t1 = threshold(q2.z > 0.f);
      const float t2 = threshold(q2.w > 0.f);
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
      const float4 q4 = row[4];
      float es[kBW];
      plane_block(q4.x, q4.y, q4.z, px, py, es);
      const int id = __float2int_rz(q6.y);
#pragma unroll
      for (int k = 0; k < kBW; ++k) {
        const float d = __fmul_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(e0[k], q3.x), __fmul_rn(e1[k], q3.y)),
                      __fmul_rn(e2[k], q3.z)),
            q3.w);
        // Rows arrive in draw order: LESSEQUAL gives a tie to this one.
        if (cov[k] && __fmul_rn(es[k], q4.w) > 0.f && d >= 0.f && d <= 1.f &&
            px[k] >= q5.y && px[k] < q5.w && d <= bd[k]) {
          bd[k] = d;
          bi[k] = id;
        }
      }
    }
  }
  if (outside) cp_async_wait<0>();

  // The carries meet in shared memory (the ring is idle: every chunk that
  // was requested has been waited for and consumed): depth at [p], id at
  // [kSubPixels + p].
  __syncthreads();
  *reinterpret_cast<float4*>(ring + brow * kSub + bx) =
      make_float4(bd[0], bd[1], bd[2], bd[3]);
  *reinterpret_cast<int4*>(ring + kSubPixels + brow * kSub + bx) =
      make_int4(bi[0], bi[1], bi[2], bi[3]);
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();

  // Epilogue: rank r finishes pixels [r, r + 1) * kSubPixels / split of the
  // sub-tile, a pixel per thread and pass, merging every rank's carry.
  const int share = kSubPixels / split;
  for (int p = rank * share + threadIdx.x; p < (rank + 1) * share;
       p += kThreads) {
    const int gx = x0 + p % kSub;
    const int gy = y0 + p / kSub;
    float wd = clear;
    int wi = -1;
    for (int r = 0; r < split; ++r) {
      const float* carry =
          split > 1 ? cluster.map_shared_rank(ring, r) : ring;
      const float d = carry[p];
      const int id = __float_as_int(carry[kSubPixels + p]);
      if (d < wd || (d == wd && id > wi)) {
        wd = d;
        wi = id;
      }
    }
    const float fx = static_cast<float>(gx) + 0.5f;
    const float fy = centre(gy, row0);
    const bool scissor = fx >= vx0 && fx < vx1 && fy >= vy0 && fy < vy1;
    if (gx < width && gy < height) {
      best_d[gy * width + gx] = scissor ? wd : clear;
      best_i[gy * width + gx] = scissor ? wi : -1;
    }
  }
  // No CTA leaves while another may still read its shared memory.
  if (split > 1) cluster.sync();
}

int num_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return sms;
}

// CTAs per sub-tile: the rows are split over a cluster while the frame has
// fewer CTAs than twice the SMs and each CTA keeps at least four stages.
int auto_split(int t, int subs) {
  int split = 1;
  while (split < kMaxSplit && subs * split < 2 * num_sms() &&
         t >= 2 * split * kStages * kChunk)
    split *= 2;
  return split;
}

}  // namespace

// `rows` is (t, 32) f32, 16-byte aligned. `row0`: the global row of the
// frame's first row (a band of a frame; 0 for a whole frame): pixel centres
// are fl(fl(y + 0.5) + row0) and the viewport is in global rows.
extern "C" int ck_reduce_flat(const float* rows, int t, const float* view5,
                              float* best_d, int* best_i, int height,
                              int width, float row0, void* stream) {
  if (t < 0 || height <= 0 || width <= 0 ||
      (reinterpret_cast<size_t>(rows) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int subs_x = (width + kSub - 1) / kSub;
  const int subs = subs_x * ((height + kSub - 1) / kSub);
  const int split = auto_split(t, subs);
  // Rows per rank, whole stages.
  const int per = ((t + split - 1) / split + kChunk - 1) / kChunk * kChunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(subs * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, reduce_flat_kernel, rows, t, per,
                                       split, view5, best_d, best_i, height,
                                       width, row0, subs_x);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The CTAs per sub-tile (the cluster size) a launch of `t` rows on a
// `height` x `width` frame takes.
extern "C" int ck_reduce_flat_split(int t, int height, int width) {
  return auto_split(t, ((width + kSub - 1) / kSub) *
                           ((height + kSub - 1) / kSub));
}

// Resident CTAs per SM; a negative CUDA error code when the query fails.
extern "C" int ck_reduce_flat_occupancy() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, reduce_flat_kernel, kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
