// The line pass (kernel L1) for Hopper (sm_90a).
//
// Replaces: ckrenderengine_tpu/pipeline/lines.py `draw_lines` (:52-142), the
// reference's line pass. That function is plain JAX, not a Pallas kernel:
// one per-pixel loop over every segment of the bank (chunks of 32, a lax.scan
// past 8 chunks), which XLA fuses into one program. Eager torch would spend
// some 15 full-frame elementwise passes per chunk instead, so the port's
// counterpart is this kernel; `pipeline/lines.py` `draw_lines_plain` is its
// plain torch version.
//
// What it computes: over fb (4, H, W) and zb (H, W), for each pixel centre
// (x + 0.5, y + 0.5 + row0), the segments of the bank in order. Segment i
// (projected endpoints a, b, depths z0, z1, a valid bit and a colour; rows
// of 12 floats made by `line_rows`) covers the pixel when the squared
// distance from the centre to its closest point (parameter t clamped to
// [0, 1]) is at most half_width^2, and the depth along the segment,
// z0 (1 - t) + z1 t, lies in [0, 1] and at most zb + z_bias. A covered pixel
// takes the segment's rgb (so the last covering segment's rgb stays) and the
// larger of its alpha and the segment's. No z write.
//
// Work split: a CTA of 256 threads per 16x16 tile, one pixel per thread,
// with the pixel's colour and its depth limit in registers. The CTA walks
// the bank in stages of 256 segments: each thread loads one row (three
// 16-byte loads) and tests the segment's box, dilated by half_width plus one
// pixel plus a bound on the rounding of the distance at the segment's and
// the tile's coordinate magnitudes (2^-20 of the largest), against the
// tile's pixel centres. A pixel outside that box cannot pass the distance
// test in f32, so the test only drops work: it is conservative, and the
// result stays exact. A ballot and one prefix over the 8 warps keep the
// survivors in bank order in shared memory (endpoint a, b - a, the clamped
// squared length, z0, z1, rgba), and every thread of the tile then takes
// them in that order. Invalid segments (padding, an endpoint behind the
// camera) never reach the list.
//
// Numerics: every product, sum and quotient is an explicit round-to-nearest
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the plain version's order
// (the library is built with --fmad=false and without flush-to-zero), and the
// clamp keeps a NaN as torch.clamp does, so the result equals
// draw_lines_plain bit for bit.
//
// Out of scope (later work): per-tile line bins made once per frame instead
// of every CTA testing every segment, wgmma and TMA.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 12;           // floats per projected segment row
constexpr int kTile = 16;          // a CTA's tile: kTile x kTile pixels
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = kThreads;   // segments tested per stage
constexpr unsigned kFullWarp = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) lines_kernel(
    const float* __restrict__ rows, int n_rows,
    const float* __restrict__ fb_in, const float* __restrict__ zb,
    float* __restrict__ fb_out, int height, int width, float row0,
    float half_width, float hw2, float z_bias) {
  __shared__ float s_ax[kStage], s_ay[kStage], s_dx[kStage], s_dy[kStage];
  __shared__ float s_len2[kStage], s_z0[kStage], s_z1[kStage];
  __shared__ float4 s_rgba[kStage];
  __shared__ int s_count[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x = blockIdx.x * kTile + (threadIdx.x % kTile);
  const int y = blockIdx.y * kTile + (threadIdx.x / kTile);
  const bool inside = x < width && y < height;
  const float px = __fadd_rn(static_cast<float>(x), 0.5f);
  const float py = __fadd_rn(__fadd_rn(static_cast<float>(y), 0.5f), row0);
  const size_t plane = static_cast<size_t>(height) * width;
  const size_t pix = static_cast<size_t>(y) * width + x;

  float r = 0.f, g = 0.f, b = 0.f, a = 0.f, zlim = 0.f;
  if (inside) {
    r = __ldg(fb_in + pix);
    g = __ldg(fb_in + plane + pix);
    b = __ldg(fb_in + 2 * plane + pix);
    a = __ldg(fb_in + 3 * plane + pix);
    zlim = __fadd_rn(__ldg(zb + pix), z_bias);
  }

  // The tile's pixel centres, and the largest coordinate magnitude there.
  const float tx0 = static_cast<float>(blockIdx.x * kTile) + 0.5f;
  const float tx1 = tx0 + static_cast<float>(kTile - 1);
  const float ty0 = __fadd_rn(static_cast<float>(blockIdx.y * kTile) + 0.5f,
                              row0);
  const float ty1 = ty0 + static_cast<float>(kTile - 1);
  const float tmag = fmaxf(fmaxf(fabsf(tx1), fabsf(ty0)), fabsf(ty1));

  for (int base = 0; base < n_rows; base += kStage) {
    const int i = base + threadIdx.x;
    bool keep = false;
    float4 q0, q1, q2;
    if (i < n_rows) {
      const float4* row = reinterpret_cast<const float4*>(rows + i * kRow);
      q0 = __ldg(row);          // ax ay bx by
      q1 = __ldg(row + 1);      // z0 z1 valid pad
      q2 = __ldg(row + 2);      // r g b a
      const float mag = fmaxf(fmaxf(fabsf(q0.x), fabsf(q0.z)),
                              fmaxf(fabsf(q0.y), fabsf(q0.w)));
      const float m = half_width + 1.f + (mag + tmag) * (1.f / 1048576.f);
      const bool misses = fmaxf(q0.x, q0.z) + m < tx0 ||
                          fminf(q0.x, q0.z) - m > tx1 ||
                          fmaxf(q0.y, q0.w) + m < ty0 ||
                          fminf(q0.y, q0.w) - m > ty1;
      keep = q1.z > 0.5f && !misses;
    }
    const unsigned ballot = __ballot_sync(kFullWarp, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      offset += w < warp ? c : 0;
      total += c;
    }
    if (keep) {
      const int k = offset + __popc(ballot & ((1u << lane) - 1u));
      const float dx = __fsub_rn(q0.z, q0.x);
      const float dy = __fsub_rn(q0.w, q0.y);
      s_ax[k] = q0.x;
      s_ay[k] = q0.y;
      s_dx[k] = dx;
      s_dy[k] = dy;
      s_len2[k] = fmaxf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                        1e-12f);
      s_z0[k] = q1.x;
      s_z1[k] = q1.y;
      s_rgba[k] = q2;
    }
    __syncthreads();
    if (inside) {
      for (int k = 0; k < total; ++k) {
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
          const float4 c = s_rgba[k];
          r = c.x;
          g = c.y;
          b = c.z;
          a = c.w > a ? c.w : a;
        }
      }
    }
    __syncthreads();
  }
  if (inside) {
    fb_out[pix] = r;
    fb_out[plane + pix] = g;
    fb_out[2 * plane + pix] = b;
    fb_out[3 * plane + pix] = a;
  }
}

}  // namespace

// Launch L1 on `stream`: `rows` (n_rows, 12) f32, 16-byte aligned; fb_in and
// fb_out (4, height, width) f32, zb (height, width) f32. Returns a CUDA
// error code (0 on success).
extern "C" int ck_draw_lines(const float* rows, int n_rows, const float* fb_in,
                             const float* zb, float* fb_out, int height,
                             int width, float row0, float half_width,
                             float hw2, float z_bias, void* stream) {
  if (n_rows < 0 || height <= 0 || width <= 0 ||
      (reinterpret_cast<size_t>(rows) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  lines_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, fb_in, zb, fb_out, height, width, row0, half_width, hw2,
      z_bias);
  return static_cast<int>(cudaGetLastError());
}
