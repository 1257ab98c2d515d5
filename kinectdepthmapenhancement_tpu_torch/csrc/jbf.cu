// Fused two-pass joint bilateral depth filter.
//
// Replaces the TPU kernel kinectdepthmapenhancement_tpu/ops/pallas_bilateral.py
// (jbf_pallas / _jbf_kernel), itself bit-identical to the XLA _jbf_core that
// the JAX kde_pipeline runs (ops/bilateral.py:115-167;
// JointBilateralFilter.cu:4-83 in the reference).  Pass 1 is the
// spatial x colour weighted mean of valid (> 50 mm) depth; pass 2 adds a depth
// Gaussian measured against the pass-1 mean.  Borders are zero padded; the
// output is 0 where there is no support.  Terms are gated on their sigma.
//
// Bound on the H100: memory traffic and launches when written as PyTorch
// ops (2 x 25 shifted-window passes over depth + 3-channel guide, each
// materialising [B, H, W] intermediates); the fused arithmetic is ~50 exp
// per pixel, small for the card.
//
// Design: one thread per output pixel; the block's depth and guide tile with
// its window/2 halo sits in shared memory; both passes run in registers, so
// the inputs are read once and the output written once.  The spatial
// weights come from the same f32 table as the plain version
// (stencil.gaussian_spatial_filter).  Built with -fmad=false, every
// operation rounds as the plain version's; only expf could differ.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr float VALID_DEPTH_MM = 50.0f;

__global__ void __launch_bounds__(TX * TY)
jbf_kernel(const float* __restrict__ depth, const float* __restrict__ guide,
           const float* __restrict__ spatial, float* __restrict__ out, int H,
           int W, int r, float color_c2, float depth_c2, int use_color,
           int use_depth) {
  extern __shared__ float sm[];
  const int win = 2 * r + 1;
  const int SW = TX + 2 * r, SH = TY + 2 * r;
  float* sd = sm;                // [SH * SW] depth
  float* sg = sd + SH * SW;      // [SH * SW * 3] guide
  float* ssp = sg + SH * SW * 3;  // [win * win] spatial weights

  const int b = blockIdx.z;
  const int bx = blockIdx.x * TX, by = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const float* db = depth + static_cast<size_t>(b) * H * W;
  const float* gb = guide + static_cast<size_t>(b) * H * W * 3;

  for (int i = tid; i < SH * SW; i += TX * TY) {
    const int yy = by - r + i / SW, xx = bx - r + i % SW;
    const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
    const size_t p = static_cast<size_t>(yy) * W + xx;
    sd[i] = in ? db[p] : 0.0f;
    sg[3 * i] = in ? gb[3 * p] : 0.0f;
    sg[3 * i + 1] = in ? gb[3 * p + 1] : 0.0f;
    sg[3 * i + 2] = in ? gb[3 * p + 2] : 0.0f;
  }
  for (int i = tid; i < win * win; i += TX * TY) ssp[i] = spatial[i];
  __syncthreads();

  const int x = bx + threadIdx.x, y = by + threadIdx.y;
  if (x >= W || y >= H) return;
  const int c = (threadIdx.y + r) * SW + threadIdx.x + r;
  const float g0 = sg[3 * c], g1 = sg[3 * c + 1], g2 = sg[3 * c + 2];

  // pass 1: spatial x colour weighted mean of valid depth
  float wsum = 0.0f, dsum = 0.0f;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      const int k = c + dy * SW + dx;
      const float nd = sd[k];
      float filt = ssp[(dy + r) * win + dx + r];
      if (use_color) {
        const float e0 = g0 - sg[3 * k], e1 = g1 - sg[3 * k + 1],
                    e2 = g2 - sg[3 * k + 2];
        const float cd = (e0 * e0 + e1 * e1) + e2 * e2;
        filt = filt * expf(-cd / color_c2);
      }
      filt = (nd > VALID_DEPTH_MM) ? filt : 0.0f;
      dsum = dsum + nd * filt;
      wsum = wsum + filt;
    }
  }
  const float mean = dsum / ((wsum > 0.0f) ? wsum : 1.0f);

  // pass 2: x depth Gaussian against the pass-1 mean
  float num = 0.0f, den = 0.0f;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      const int k = c + dy * SW + dx;
      const float nd = sd[k];
      float filt = ssp[(dy + r) * win + dx + r];
      if (use_color) {
        const float e0 = g0 - sg[3 * k], e1 = g1 - sg[3 * k + 1],
                    e2 = g2 - sg[3 * k + 2];
        const float cd = (e0 * e0 + e1 * e1) + e2 * e2;
        filt = filt * expf(-cd / color_c2);
      }
      if (use_depth) {
        const float e = nd - mean;
        filt = filt * expf(-(e * e) / depth_c2);
      }
      filt = (nd > VALID_DEPTH_MM) ? filt : 0.0f;
      num = num + nd * filt;
      den = den + filt;
    }
  }
  float o = (den != 0.0f) ? num / ((den != 0.0f) ? den : 1.0f) : 0.0f;
  out[static_cast<size_t>(b) * H * W + static_cast<size_t>(y) * W + x] =
      (wsum > 0.0f) ? o : 0.0f;
}

}  // namespace

// depth: [B, H, W] f32 mm; guide: [B, H, W, 3] f32; spatial: [(2r+1)^2] f32
// (device); out: [B, H, W] f32.  color_c2 = 2 sigma_c^2, depth_c2 = 2 sigma_d^2.
extern "C" int kde_jbf(const float* depth, const float* guide, const float* spatial,
                       float* out, int B, int H, int W, int r, float color_c2,
                       float depth_c2, int use_color, int use_depth, void* stream) {
  if (r < 0 || r > 8) return static_cast<int>(cudaErrorInvalidValue);
  const int SW = TX + 2 * r, SH = TY + 2 * r, win = 2 * r + 1;
  const size_t smem = (static_cast<size_t>(SH) * SW * 4 + win * win) * sizeof(float);
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  jbf_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      depth, guide, spatial, out, H, W, r, color_c2, depth_c2, use_color,
      use_depth);
  return static_cast<int>(cudaGetLastError());
}
