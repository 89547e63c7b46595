// The line pass (kernel L1) for Hopper (sm_90a): a bin step, then the draw.
//
// Replaces: ckrenderengine_tpu/pipeline/lines.py `draw_lines` (:52-142), the
// reference's line pass. That function is plain JAX, not a Pallas kernel:
// one per-pixel loop over every segment of the bank (chunks of 32, a lax.scan
// past 8 chunks), which XLA fuses into one program. Eager torch would spend
// some 15 full-frame elementwise passes per chunk instead, so the port's
// counterpart is this kernel; `pipeline/lines.py` `draw_lines_plain` is its
// plain torch version and `line_bins_plain` that of the bin step.
//
// What it computes: over fb (4, H, W) and zb (H, W), for each pixel centre
// (x + 0.5, y + 0.5 + row0), the segments of the bank in order. Segment i
// (projected endpoints a, b, depths z0, z1, a valid bit and a colour; rows
// of 12 floats made by `line_rows`) covers the pixel when the squared
// distance from the centre to its closest point (parameter t clamped to
// [0, 1]) is at most half_width^2, and the depth along the segment,
// z0 (1 - t) + z1 t, lies in [0, 1] and at most zb + z_bias. A covered pixel
// takes the rgb of the highest covering segment and the maximum of its alpha
// and every covering segment's alpha, a NaN winning as in torch.maximum. No
// z write. The result is a new fb.
//
// What bounds it: the bytes. fb is read and written and zb read once: 36
// bytes a pixel, 28.3 MB at 1024x768. The arithmetic of the pairs a segment
// really covers is some hundreds of times smaller.
//
// Work split: the frame is cut into 32x8 tiles; two launches per call.
//
// 1. line_bins_kernel writes, for every tile, a bitmask over the bank:
//    ceil(L/32) words, bit j of word w for segment 32 w + j, so that bank
//    order is bit order. A CTA takes one tile row and 256 segments (8 words
//    of every tile in the row): it clears those words in shared memory, each
//    thread tests its segment against the tiles of the row that the
//    segment's box can reach, sets bits with shared atomics, and the CTA
//    stores its words whole. Each word is stored by exactly one CTA, so the
//    bins need no clear pass and the result does not depend on timing.
//    The (tile, segment) test keeps the pair unless it proves that no pixel
//    centre of the tile can pass the distance test in f32:
//    - the box test: the segment's box dilated by m = half_width + 1 +
//      2^-20 (mag + tmag), mag and tmag the largest coordinate magnitudes of
//      the segment and of the tile's pixel centres, against those centres;
//    - the capsule test (where mag <= 2^40, so no product overflows): the
//      rect of pixel centres (half extents 15.5 and 3.5) dilated by m lies
//      wholly on one side of the segment's line, |d x (c - a)| > |dx| (3.5 +
//      m) + |dy| (15.5 + m) with c the rect's centre. A diagonal across the
//      frame keeps only the tiles along it.
//    A pixel the draw covers lies within half_width + 2^-22 (mag + tmag) of
//    the segment (a + t d with the f32 d and t in [0, 1]); each test's own
//    f32 rounding is below 2^-21 (mag + tmag) in the same units, so the
//    spare pixel and the 2^-20 term keep both tests conservative, and the
//    draw's result is exact. Not binned: invalid rows (valid <= 0.5) and
//    rows with an infinite or NaN endpoint coordinate. Such a row covers no
//    pixel: its dx or dy is infinite or NaN, so len2 is infinite or NaN and
//    the numerator of t infinite or NaN, t is NaN, the clamp keeps the NaN,
//    and dist2 <= hw^2 fails.
// 2. lines_kernel: one CTA of 256 threads per tile, one pixel per thread,
//    its colour and depth limit in registers; a warp reads and writes one
//    128-byte line of each plane. The CTA reads its tile's words 64 at a
//    time (the first ones while the pixels load), lays the set bits out in
//    bank order in shared memory (a prefix over the words' popcounts),
//    loads only those rows, 256 per stage (endpoint a, b - a, the clamped
//    squared length, z0, z1, rgba), and every thread walks them in that
//    order. A tile with an empty bin is a straight copy of fb.
//    Why one pixel per thread: the CTAs of a 1024x768 frame are nearly all
//    resident at once, so the draw ends with its slowest tile, whose
//    threads walk its whole bin. With four pixels per thread in 16-byte accesses each
//    thread walks four times as long; on the H100 that layout was slower at
//    1024x768 and faster only at 2048x1536, where more bytes are in flight
//    per SM. Staging 16-byte accesses through shared memory was slower at
//    every shape.
//
// Numerics: every product, sum and quotient is an explicit round-to-nearest
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the plain version's order
// (the library is built with --fmad=false and without flush-to-zero), and the
// clamp keeps a NaN as torch.clamp does, so the result equals
// draw_lines_plain bit for bit and the bins equal line_bins_plain.
//
// Out of scope (later work): a persistent grid that loads the next tile's
// pixels while it walks a bin (four pixels a thread without the long walk);
// wgmma and TMA have no product to feed.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 12;             // floats per projected segment row
constexpr int kTileW = 32;           // a tile: kTileW x kTileH pixels
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;   // draw: one CTA per tile
constexpr int kWarps = kThreads / 32;
constexpr int kStage = kThreads;     // rows loaded per stage
constexpr int kChunkWords = 64;      // bin words laid out at a time
constexpr int kBinThreads = 256;     // bin step: segments per CTA
constexpr int kBinWords = kBinThreads / 32;
constexpr float kRel = 1.f / 1048576.f;           // 2^-20
constexpr float kCapsuleMag = 1099511627776.f;    // 2^40
constexpr unsigned kFullWarp = 0xffffffffu;

// Whether segment (ax, ay)-(bx, by), d = (dx, dy) its f32 difference and mag
// its largest coordinate magnitude, may cover a pixel centre of the tile
// whose first centre is (tx0, ty0). hw1 = half_width + 1.
__device__ __forceinline__ bool reaches(float ax, float ay, float bx,
                                        float by, float dx, float dy,
                                        float mag, float hw1, float tx0,
                                        float ty0) {
  const float tx1 = __fadd_rn(tx0, static_cast<float>(kTileW - 1));
  const float ty1 = __fadd_rn(ty0, static_cast<float>(kTileH - 1));
  const float tmag = fmaxf(fmaxf(fabsf(tx1), fabsf(ty0)), fabsf(ty1));
  const float m = __fadd_rn(hw1, __fmul_rn(__fadd_rn(mag, tmag), kRel));
  if (__fadd_rn(fmaxf(ax, bx), m) < tx0 || __fsub_rn(fminf(ax, bx), m) > tx1 ||
      __fadd_rn(fmaxf(ay, by), m) < ty0 || __fsub_rn(fminf(ay, by), m) > ty1)
    return false;
  if (!(mag <= kCapsuleMag)) return true;
  const float ex = __fsub_rn(__fadd_rn(tx0, 0.5f * (kTileW - 1)), ax);
  const float ey = __fsub_rn(__fadd_rn(ty0, 0.5f * (kTileH - 1)), ay);
  const float cr = __fsub_rn(__fmul_rn(dx, ey), __fmul_rn(dy, ex));
  const float rhs =
      __fadd_rn(__fmul_rn(fabsf(dx), __fadd_rn(m, 0.5f * (kTileH - 1))),
                __fmul_rn(fabsf(dy), __fadd_rn(m, 0.5f * (kTileW - 1))));
  return !(fabsf(cr) > rhs);
}

// Grid (ceil(n_words / kBinWords), tiles_y); dynamic shared memory
// tiles_x * kBinWords words. bins: (tiles_y * tiles_x, n_words).
__global__ void __launch_bounds__(kBinThreads) line_bins_kernel(
    const float* __restrict__ rows, int n_rows, unsigned* __restrict__ bins,
    int n_words, int tiles_x, float row0, float half_width) {
  extern __shared__ unsigned s_bins[];
  const int ty = blockIdx.y;
  const int w0 = blockIdx.x * kBinWords;
  const int n_shared = tiles_x * kBinWords;
  for (int k = threadIdx.x; k < n_shared; k += kBinThreads) s_bins[k] = 0u;
  __syncthreads();

  const int i = w0 * 32 + threadIdx.x;
  if (i < n_rows) {
    const float* row = rows + static_cast<size_t>(i) * kRow;
    const float4 q = __ldg(reinterpret_cast<const float4*>(row));
    const float ax = q.x, ay = q.y, bx = q.z, by = q.w;
    if (__ldg(row + 6) > 0.5f && isfinite(ax) && isfinite(ay) &&
        isfinite(bx) && isfinite(by)) {
      const float hw1 = __fadd_rn(half_width, 1.f);
      const float dx = __fsub_rn(bx, ax);
      const float dy = __fsub_rn(by, ay);
      const float mag = fmaxf(fmaxf(fabsf(ax), fabsf(bx)),
                              fmaxf(fabsf(ay), fabsf(by)));
      const float ty0 = __fadd_rn(
          __fadd_rn(static_cast<float>(ty * kTileH), 0.5f), row0);
      const float ty1 = __fadd_rn(ty0, static_cast<float>(kTileH - 1));
      // The row's widest margin (at its last tile) bounds every tile's:
      // the tiles that pass the box test lie in [lo, hi].
      const float xr = __fadd_rn(
          __fadd_rn(static_cast<float>((tiles_x - 1) * kTileW), 0.5f),
          static_cast<float>(kTileW - 1));
      const float tmag = fmaxf(fmaxf(fabsf(xr), fabsf(ty0)), fabsf(ty1));
      const float m = __fadd_rn(hw1, __fmul_rn(__fadd_rn(mag, tmag), kRel));
      if (!(__fadd_rn(fmaxf(ay, by), m) < ty0 ||
            __fsub_rn(fminf(ay, by), m) > ty1)) {
        const float inv = 1.f / kTileW;
        float lo = floorf(__fmul_rn(
            __fsub_rn(__fsub_rn(fminf(ax, bx), m), kTileW - 0.5f), inv));
        float hi = floorf(__fmul_rn(
            __fsub_rn(__fadd_rn(fmaxf(ax, bx), m), 0.5f), inv));
        lo = fminf(fmaxf(lo - 1.f, 0.f), static_cast<float>(tiles_x));
        hi = fmaxf(fminf(hi + 1.f, static_cast<float>(tiles_x - 1)), -1.f);
        const int word = threadIdx.x >> 5;
        const unsigned bit = 1u << (threadIdx.x & 31);
        for (int tx = static_cast<int>(lo); tx <= static_cast<int>(hi); ++tx) {
          const float tx0 = __fadd_rn(static_cast<float>(tx * kTileW), 0.5f);
          if (reaches(ax, ay, bx, by, dx, dy, mag, hw1, tx0, ty0))
            atomicOr(&s_bins[tx * kBinWords + word], bit);
        }
      }
    }
  }
  __syncthreads();
  unsigned* out = bins + static_cast<size_t>(ty) * tiles_x * n_words + w0;
  const int nw = min(kBinWords, n_words - w0);
  for (int k = threadIdx.x; k < n_shared; k += kBinThreads) {
    const int tx = k / kBinWords, j = k % kBinWords;
    if (j < nw) out[static_cast<size_t>(tx) * n_words + j] = s_bins[k];
  }
}

// Grid (tiles_x, tiles_y), kThreads threads, one pixel each: a warp reads
// and writes one 128-byte line of each plane.
__global__ void __launch_bounds__(kThreads) lines_kernel(
    const float* __restrict__ rows, const unsigned* __restrict__ bins,
    int n_words, const float* __restrict__ fb_in,
    const float* __restrict__ zb, float* __restrict__ fb_out, int height,
    int width, float row0, float hw2, float z_bias) {
  __shared__ unsigned short s_idx[kChunkWords * 32];
  __shared__ float s_ax[kStage], s_ay[kStage], s_dx[kStage], s_dy[kStage];
  __shared__ float s_len2[kStage], s_z0[kStage], s_z1[kStage];
  __shared__ float4 s_rgba[kStage];
  __shared__ int s_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x = blockIdx.x * kTileW + tid % kTileW;
  const int y = blockIdx.y * kTileH + tid / kTileW;
  const bool inside = x < width && y < height;
  const size_t plane = static_cast<size_t>(height) * width;
  const size_t pix = static_cast<size_t>(y) * width + x;
  const unsigned* tb =
      bins + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                 n_words;
  // The first words of the bin, on their way while the pixels load.
  unsigned word = tid < kChunkWords && tid < n_words ? __ldg(tb + tid) : 0u;

  float r = 0.f, g = 0.f, b = 0.f, a = 0.f, zlim = 0.f;
  if (inside) {
    r = __ldg(fb_in + pix);
    g = __ldg(fb_in + plane + pix);
    b = __ldg(fb_in + 2 * plane + pix);
    a = __ldg(fb_in + 3 * plane + pix);
    zlim = __fadd_rn(__ldg(zb + pix), z_bias);
  }
  const float px = __fadd_rn(static_cast<float>(x), 0.5f);
  const float py = __fadd_rn(__fadd_rn(static_cast<float>(y), 0.5f), row0);

  for (int w0 = 0; w0 < n_words; w0 += kChunkWords) {
    if (w0 > 0)
      word = tid < kChunkWords && w0 + tid < n_words ? __ldg(tb + w0 + tid)
                                                     : 0u;
    const int cnt = __popc(word);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFullWarp, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_count[warp] = incl;
    __syncthreads();
    int off = incl - cnt, total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int n = s_count[k];
      off += k < warp ? n : 0;
      total += n;
    }
    while (word) {
      s_idx[off++] = static_cast<unsigned short>((tid << 5) |
                                                 (__ffs(word) - 1));
      word &= word - 1u;
    }
    __syncthreads();
    for (int s0 = 0; s0 < total; s0 += kStage) {
      const int n = min(kStage, total - s0);
      if (tid < n) {
        const int i = w0 * 32 + s_idx[s0 + tid];
        const float4* row =
            reinterpret_cast<const float4*>(rows + static_cast<size_t>(i) * kRow);
        const float4 q0 = __ldg(row);      // ax ay bx by
        const float4 q1 = __ldg(row + 1);  // z0 z1 valid pad
        const float dx = __fsub_rn(q0.z, q0.x);
        const float dy = __fsub_rn(q0.w, q0.y);
        s_ax[tid] = q0.x;
        s_ay[tid] = q0.y;
        s_dx[tid] = dx;
        s_dy[tid] = dy;
        s_len2[tid] = fmaxf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            1e-12f);
        s_z0[tid] = q1.x;
        s_z1[tid] = q1.y;
        s_rgba[tid] = __ldg(row + 2);    // r g b a
      }
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        const float dx = s_dx[k], dy = s_dy[k];
        const float pax = __fsub_rn(px, s_ax[k]);
        const float pay = __fsub_rn(py, s_ay[k]);
        float t = __fdiv_rn(__fadd_rn(__fmul_rn(pax, dx), __fmul_rn(pay, dy)),
                            s_len2[k]);
        t = t < 0.f ? 0.f : t;
        t = t > 1.f ? 1.f : t;
        const float ddx = __fsub_rn(pax, __fmul_rn(t, dx));
        const float ddy = __fsub_rn(pay, __fmul_rn(t, dy));
        const float dist2 = __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy));
        if (!(dist2 <= hw2)) continue;
        const float zline = __fadd_rn(__fmul_rn(s_z0[k], __fsub_rn(1.f, t)),
                                      __fmul_rn(s_z1[k], t));
        if (zline <= zlim && zline >= 0.f && zline <= 1.f) {
          const float4 col = s_rgba[k];
          r = col.x;
          g = col.y;
          b = col.z;
          // torch.maximum: the larger, and a NaN of either side wins.
          a = (col.w > a || col.w != col.w) ? col.w : a;
        }
      }
      __syncthreads();
    }
  }

  if (inside) {
    fb_out[pix] = r;
    fb_out[plane + pix] = g;
    fb_out[2 * plane + pix] = b;
    fb_out[3 * plane + pix] = a;
  }
}

}  // namespace

// The bin step on `stream`: `rows` (n_rows, 12) f32, 16-byte aligned; bins
// (ceil(height / 8) * ceil(width / 32), ceil(n_rows / 32)) 32-bit words,
// every one written. Returns a CUDA error code (0 on success; nothing is
// launched for an empty bank).
extern "C" int ck_line_bins(const float* rows, int n_rows, unsigned* bins,
                            int height, int width, float row0,
                            float half_width, void* stream) {
  if (n_rows < 0 || height <= 0 || width <= 0 ||
      (reinterpret_cast<size_t>(rows) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kTileH - 1) / kTileH;
  const int n_words = (n_rows + 31) / 32;
  const size_t smem = static_cast<size_t>(tiles_x) * kBinWords * 4;
  if (tiles_y > 65535 || smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        line_bins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n_words + kBinWords - 1) / kBinWords, tiles_y);
  line_bins_kernel<<<grid, kBinThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, bins, n_words, tiles_x, row0, half_width);
  return static_cast<int>(cudaGetLastError());
}

// The draw on `stream`: `rows` (n_rows, 12) f32, 16-byte aligned; bins as
// ck_line_bins wrote them (unread when n_rows is 0: a copy); fb_in and
// fb_out (4, height, width) f32, zb (height, width) f32. Returns a CUDA error
// code (0 on success).
extern "C" int ck_draw_lines(const float* rows, int n_rows,
                             const unsigned* bins, const float* fb_in,
                             const float* zb, float* fb_out, int height,
                             int width, float row0, float hw2, float z_bias,
                             void* stream) {
  if (n_rows < 0 || height <= 0 || width <= 0 ||
      (reinterpret_cast<size_t>(rows) & 15) || (n_rows > 0 && !bins))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_y = (height + kTileH - 1) / kTileH;
  if (tiles_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((width + kTileW - 1) / kTileW, tiles_y);
  const int n_words = (n_rows + 31) / 32;
  lines_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, bins, n_words, fb_in, zb, fb_out, height, width, row0, hw2,
      z_bias);
  return static_cast<int>(cudaGetLastError());
}
