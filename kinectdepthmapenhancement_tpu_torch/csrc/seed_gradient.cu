// SLIC seed-sampling gradient over an 11x11 edge-clamped window.
//
// Replaces the TPU kernel kinectdepthmapenhancement_tpu/ops/pallas_gradient.py
// (seed_gradient / _grad_kernel): the mean colour distance to the window
// neighbours (sampleInitialClusters, SuperpixelSegmentation.cu:39-60), and in
// the NASP form (NormalAdaptiveSuperpixel.cu:39-71) each term scaled by
// 1 - |n.n'| where both normals are valid.  Only terms g > 0 count; the
// output is +inf where none does.
//
// Bound on the H100: launches, then FLOPs.  On the NASP seed sub-grid
// (270x360 at 640x480) the input is 2.3 MB and the arithmetic ~0.25 GFLOP
// (121 taps x ~20 operations per pixel); as PyTorch ops the 121 window
// offsets are ~2000 small launches.
//
// Design: one launch, one thread per pixel, neighbours read through the
// read-only cache with indices clamped to the array that is passed in (the
// edge padding of pallas_gradient.py:101-104).  The accumulation order is
// dy outer, dx inner; the sums keep the (c0 + c1) + c2 and
// (n0 n0' + n1 n1') + n2 n2' association; sqrt and division are IEEE.
// Built with -fmad=false the result is bitwise equal to the plain version:
// it feeds an argmin with near-ties (slic.py:533).

#include <cuda_runtime.h>

namespace {

constexpr int R = 5;
constexpr int TX = 32;
constexpr int TY = 8;

__global__ void __launch_bounds__(TX * TY)
grad_kernel(const float* __restrict__ color, const float* __restrict__ normals,
            float* __restrict__ out, int H, int W, int nasp) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const size_t base = static_cast<size_t>(b) * H * W;
  const float* cb = color + base * 3;
  const float* nb = nasp ? normals + base * 3 : nullptr;
  const size_t ci = (static_cast<size_t>(y) * W + x) * 3;
  const float a0 = __ldg(cb + ci), a1 = __ldg(cb + ci + 1), a2 = __ldg(cb + ci + 2);
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
  bool valid_c = false;
  if (nasp) {
    n0 = __ldg(nb + ci);
    n1 = __ldg(nb + ci + 1);
    n2 = __ldg(nb + ci + 2);
    valid_c = (n0 != -1.0f) && (n1 != -1.0f) && (n2 != -1.0f);
  }

  float sum_g = 0.0f, count = 0.0f;
  for (int dy = -R; dy <= R; ++dy) {
    const int yy = min(max(y + dy, 0), H - 1);
    for (int dx = -R; dx <= R; ++dx) {
      const int xx = min(max(x + dx, 0), W - 1);
      const size_t k = (static_cast<size_t>(yy) * W + xx) * 3;
      const float d0 = a0 - __ldg(cb + k);
      const float d1 = a1 - __ldg(cb + k + 1);
      const float d2 = a2 - __ldg(cb + k + 2);
      float g = sqrtf((d0 * d0 + d1 * d1) + d2 * d2);
      if (nasp) {
        const float m0 = __ldg(nb + k), m1 = __ldg(nb + k + 1), m2 = __ldg(nb + k + 2);
        const bool both =
            valid_c && (m0 != -1.0f) && (m1 != -1.0f) && (m2 != -1.0f);
        const float ndiff = fabsf((n0 * m0 + n1 * m1) + n2 * m2);
        if (both) g = g * (1.0f - ndiff);
      }
      sum_g = sum_g + g;
      count = count + ((g > 0.0f) ? 1.0f : 0.0f);
    }
  }
  out[base + static_cast<size_t>(y) * W + x] =
      (count > 0.0f) ? sum_g / fmaxf(count, 1.0f) : __int_as_float(0x7f800000);
}

}  // namespace

// color: [B, H, W, 3] f32; normals: [B, H, W, 3] f32 or null when nasp == 0;
// out: [B, H, W] f32.
extern "C" int kde_seed_gradient(const float* color, const float* normals,
                                 float* out, int B, int H, int W, int nasp,
                                 void* stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  grad_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      color, normals, out, H, W, nasp);
  return static_cast<int>(cudaGetLastError());
}
