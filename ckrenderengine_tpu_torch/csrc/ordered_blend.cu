// Ordered alpha blend, phase B (kernel B3) for Hopper (sm_90a).
//
// Replaces: ckrenderengine_tpu/raster/pallas_ordered.py `_blend_kernel`
// (entry `ordered_blend_tiled_pallas`, phase A `_ordered_phase_a`), the
// Pallas TPU kernel that folds each pixel's draw-ordered blend steps into an
// affine map while the tile's rows stream through VMEM.
//
// What it computes: every blend the transparent path uses is affine in the
// destination colour, out = a*dst + b (alpha-over a = 1 - sa, b = src*sa;
// replace a = 0, b = src; an uncovered or discarded fragment is the
// identity). For each screen tile the kernel walks the tile's range
// [start, start + count) of the draw-ordered row stream; for each covering
// fragment (ordered_common.cuh `cover_block`) it interpolates colour and
// specular, applies fog, saturates, runs the alpha test, and folds the step
// after the carry: A <- a*A, B <- a*B + b per channel. The frame then takes
// fb' = A*fb + B. The four A channels are one number (a is one number per
// fragment), so the output is 5 planes: A, then B's RGBA.
//
// What bounds it on the card. By the repo's roofline count, bytes: at
// alpha50k (1024x768) the tiles stream 65,643 live rows of 60 floats
// (15.8 MB), read the 3.1 MB opaque depth plane and write 5 planes
// (15.7 MB): 34.6 MB, 0.0103 ms at 3.35 TB/s; the 10.9 M of 67.2 M (pixel,
// row) pairs that pass rect and edges need ~15 operations each, 0.0049 ms.
// That count leaves out the shade, which only covered fragments pay: a
// division and some ninety dependent operations each, on lanes that the
// other pixels of their warp leave idle. With the scan in place the shade
// is where the time goes (B4, the same walk without it, takes under half
// of B3's time). The kernel before this design (one CTA per tile, a thread
// per pixel, synchronous staging, every row on every pixel, 8 output
// planes) ran 0.2945 ms.
//
// Design (the walk is ordered_common.cuh `walk`, shared with B4):
//  * Rows are a 16-byte multiple (head + 32 floats), so a chunk of
//    kchunk = 32 rows is one run of 16-byte `cp.async.cg` copies into a
//    kStages = 4 deep ring: an average tile's whole range is in flight
//    before its first row is evaluated. One `cp.async.wait_group` and one
//    `__syncthreads()` per chunk. B3 copies whole rows: the shade reads the
//    tail.
//  * A CTA per 16x16 sub-tile of a 32x32 tile (the whole of a 16x16 one),
//    so a tile's chain runs on four SMs; a 1 x 2 block of pixels per
//    thread (128 threads) with the carry (A and B's RGBA) in registers.
//  * Each warp scans 32 rows at a time against its 16x4 strip, exactly
//    (valid, colorwrite, rect overlap, each edge and clip plane at the
//    corner its signs pick), and meets the survivors in draw order: the
//    block's rect, three edge planes with b*py shared, one `__any_sync`,
//    then esum, depth and the z test; the row's shade tail is read from
//    shared memory once for the block, and the shade with its IEEE
//    division runs only for the pixels that are covered.
//  * The epilogue stores a block's pixels as one 8-byte store per plane.
//
// Tried on the card and dropped (first-frame shapes of alpha50k, 50,243
// rows, the kernel's own time under torch.profiler, NVIDIA H100 80GB HBM3,
// 700 W; the kept design 0.1193 ms): 1 x 4 blocks, 0.1655 ms with the
// first arrangement of the walk and 0.1192 ms with this one (64 threads,
// the same time with half the warps); 1 x 1 blocks, 0.1353 ms; one
// 256-thread CTA per 32x32 tile sharing one ring (1 x 4 blocks), 0.1601
// ms, and 512 threads with 1 x 2 blocks, 0.1615 ms (a tile's chain back on
// one SM); a per-lane walk of the survivors (each lane skips to its own
// next covering row, then the lanes that found one shade together), 0.1334
// ms: the shade's lanes fill up, but the scan and coverage lose the strip's
// shared products and the registers cut the CTAs to 4 per SM; 64-row
// chunks, 0.2793 ms (3 CTAs per SM), or 2 stages of 64 rows and 3 stages of
// 32, within 10% of the kept setting.
//
// Numerics: explicit round-to-nearest operations in the reference's order
// (no contraction; built with --fmad=false), so A and B equal the plain
// torch version (raster/cuda_ordered.py blend_phase_b_plain) bit for bit.

#include "ordered_common.cuh"

namespace {

using namespace ck_ordered;

constexpr int kBW = 2;      // pixels per thread: a 1 x kBW block
constexpr int kThreads = kSub * kSub / kBW;

__device__ __forceinline__ float interp(const float* r, int k, float w0,
                                        float w1, float w2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], w0), __fmul_rn(r[k], w1)),
                   __fmul_rn(r[2 * k], w2));
}

// The step a covering fragment adds to its pixel's carry (ca, cb), from the
// row's state bits, inverse determinant and shade tail `tl` and the
// fragment's raw edge values: interpolate colour and specular, fog,
// saturate, alpha-test (a fragment that fails is the identity), fold.
__device__ __forceinline__ void shade_fold(const float (&tl)[kTail], int bits,
                                           float ivs, float e0, float e1,
                                           float e2, const float (&fogc)[3],
                                           float& ca, float (&cb)[4]) {
  const float esum = __fadd_rn(__fadd_rn(e0, e1), e2);
  const float inv_esum = __fdiv_rn(1.f, fabsf(esum) < 1e-30f ? 1e-30f : esum);
  const bool persp = (bits & 8) != 0;
  const float w0 = persp ? __fmul_rn(e0, inv_esum)
                         : __fmul_rn(__fmul_rn(e0, tl[kWs]), ivs);
  const float w1 = persp ? __fmul_rn(e1, inv_esum)
                         : __fmul_rn(__fmul_rn(e1, tl[kWs + 1]), ivs);
  const float w2 = persp ? __fmul_rn(e2, inv_esum)
                         : __fmul_rn(__fmul_rn(e2, tl[kWs + 2]), ivs);
  float src[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) src[c] = interp(tl + kCol + c, 4, w0, w1, w2);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    src[c] = __fadd_rn(src[c], interp(tl + kSpc + c, 3, w0, w1, w2));
  if ((bits & 2) != 0) {
    const float f = clamp01(interp(tl + kFog, 1, w0, w1, w2));
    const float g = __fsub_rn(1.f, f);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      src[c] = __fadd_rn(__fmul_rn(src[c], f), __fmul_rn(fogc[c], g));
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) src[c] = clamp01(src[c]);
  const float sa = src[3];
  if ((bits & 16) != 0 && !compare(__float2int_rz(tl[kAf]), sa, tl[kAref]))
    return;
  const bool blend_on = (bits & 1) != 0;
  const float a = blend_on ? __fsub_rn(1.f, sa) : 0.f;
  ca = __fmul_rn(a, ca);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    cb[c] = __fadd_rn(__fmul_rn(a, cb[c]),
                      blend_on ? __fmul_rn(src[c], sa) : src[c]);
}

__global__ void __launch_bounds__(kThreads) ordered_blend_kernel(
    const float* __restrict__ rows, int rpitch, int head, int n_planes,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ params, const float* __restrict__ zplane,
    float* __restrict__ out, int tile, int tiles_x, int pitch, int plane_size,
    int kchunk) {
  extern __shared__ float4 ring4[];
  const Block<kBW> b = block_of<kBW>(params, zplane, tile, tiles_x, pitch);
  const int start = __ldg(starts + b.tile);
  const int count = __ldg(counts + b.tile);
  const float fogc[3] = {__ldg(params + 7), __ldg(params + 8),
                         __ldg(params + 9)};
  float ca[kBW];
  float cb[kBW][4];
#pragma unroll
  for (int k = 0; k < kBW; ++k) {
    ca[k] = 1.f;
    cb[k][0] = cb[k][1] = cb[k][2] = cb[k][3] = 0.f;
  }

  auto visit = [&](const float* row, const bool (&cov)[kBW],
                   const float (&e0)[kBW], const float (&e1)[kBW],
                   const float (&e2)[kBW]) {
    // The row's shade tail, once for the block's pixels.
    float tl[kTail];
    const float4* t4 = reinterpret_cast<const float4*>(row + head);
#pragma unroll
    for (int q = 0; q < kTail / 4; ++q) {
      const float4 v = t4[q];
      tl[4 * q] = v.x;
      tl[4 * q + 1] = v.y;
      tl[4 * q + 2] = v.z;
      tl[4 * q + 3] = v.w;
    }
    const int bits = __float2int_rz(row[kBits]);
    const float ivs = row[kIvs];
#pragma unroll
    for (int k = 0; k < kBW; ++k)
      if (cov[k])
        shade_fold(tl, bits, ivs, e0[k], e1[k], e2[k], fogc, ca[k], cb[k]);
  };
  walk<kThreads>(reinterpret_cast<float*>(ring4), rows, rpitch, rpitch,
                 n_planes, start, count, kchunk, b,
                 [&](const float* rows32, unsigned todo) {
                   each_survivor(rows32, rpitch, todo, n_planes, b, visit);
                 });

  store_block<kBW>(out + b.pix, ca);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float v[kBW];
#pragma unroll
    for (int k = 0; k < kBW; ++k) v[k] = cb[k][c];
    store_block<kBW>(out + (1 + c) * static_cast<size_t>(plane_size) + b.pix,
                     v);
  }
}

}  // namespace

// `rows` is the (n, rpitch) ordered stream, 16-byte aligned, rpitch =
// head_width(n_planes) + kTail; `out` is (5, H_pad, W_pad): A, then B RGBA.
extern "C" int ck_ordered_blend(const float* rows, int rpitch, int n_planes,
                                const int* starts, const int* counts,
                                const float* params, const float* zplane,
                                float* out, int tile, int tiles_x,
                                int tiles_y, int kchunk, void* stream) {
  Launch g;
  if (!geometry(kBW, rpitch, rpitch, n_planes, tile, tiles_x, tiles_y,
                kchunk, &g) ||
      (reinterpret_cast<size_t>(rows) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ordered_blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ordered_blend_kernel<<<g.grid, g.block, g.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      rows, rpitch, head_width(n_planes), n_planes, starts, counts, params,
      zplane, out, tile, tiles_x, g.pitch, g.plane_size, kchunk);
  return static_cast<int>(cudaGetLastError());
}

// Resident CTAs per SM at a launch's shapes; a negative CUDA error code
// when the shapes are not taken.
extern "C" int ck_ordered_blend_occupancy(int n_planes, int tile,
                                          int kchunk) {
  Launch g;
  const int rpitch = head_width(n_planes) + kTail;
  if (!geometry(kBW, rpitch, rpitch, n_planes, tile, 1, 1, kchunk, &g))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      ordered_blend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ordered_blend_kernel, static_cast<int>(g.block.x), g.smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
