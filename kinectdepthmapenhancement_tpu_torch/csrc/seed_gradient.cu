// SLIC seed-sampling gradient over an 11x11 edge-clamped window.
//
// Replaces the TPU kernel kinectdepthmapenhancement_tpu/ops/pallas_gradient.py
// (seed_gradient / _grad_kernel): the mean colour distance to the window
// neighbours (sampleInitialClusters, SuperpixelSegmentation.cu:39-60), and in
// the NASP form (NormalAdaptiveSuperpixel.cu:39-71) each term scaled by
// 1 - |n.n'| where both normals are valid.  Only terms g > 0 count; the
// output is +inf where none does.
//
// Bound on the H100: instruction issue.  On the NASP seed sub-grid (270x360
// at 640x480) the input is 2.3 MB, but each pixel runs 121 taps of ~20 f32
// operations, an IEEE sqrt among them, which bitwise equality to the plain
// version keeps (-fmad=false, no fast math): it feeds an argmin with
// near-ties (slic.py:533).
//
// Design: a thread computes P vertically adjacent pixels of a TX x TY*P
// block tile.  The block stages its tile and the 5-pixel halo in shared
// memory once, with the edge clamp (the replicate padding of
// pallas_gradient.py:101-104) applied at load: colour as float4
// (c0, c1, c2, 0) and, in the NASP form, the normal as float4
// (n0, n1, n2, valid), the validity of each pixel's normal formed once
// there instead of at every tap that reads it.  The form is a template
// parameter.  The taps are unrolled; the thread walks the window rows of
// its P pixels once, so a staged neighbour is loaded once for all the
// pixels whose window holds it, and each pixel still adds its terms dy
// outer, dx inner.  The sums keep the (c0 + c1) + c2 and
// (n0 n0' + n1 n1') + n2 n2' association; sqrt and division are IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int R = 5;   // the 11x11 window's half-width
constexpr int TX = 24;  // block width, threads (W = 360 on the path: 15 blocks)
constexpr int TY = 16;  // block height, threads
constexpr int P = 1;    // vertically adjacent pixels a thread
constexpr int SW = TX + 2 * R, SH = TY * P + 2 * R;

template <bool NASP>
__global__ void __launch_bounds__(TX * TY)
grad_kernel(const float* __restrict__ color, const float* __restrict__ normals,
            float* __restrict__ out, int H, int W) {
  __shared__ float4 sc[SH * SW];            // colour
  __shared__ float4 sn[NASP ? SH * SW : 1];  // normal and its validity

  const int b = blockIdx.z;
  const int bx = blockIdx.x * TX, by = blockIdx.y * TY * P;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const size_t base = static_cast<size_t>(b) * H * W;
  const float* cb = color + base * 3;
  const float* nb = NASP ? normals + base * 3 : nullptr;
  for (int i = tid; i < SH * SW; i += TX * TY) {
    const int yy = min(max(by - R + i / SW, 0), H - 1);
    const int xx = min(max(bx - R + i % SW, 0), W - 1);
    const size_t k = (static_cast<size_t>(yy) * W + xx) * 3;
    sc[i] = make_float4(__ldg(cb + k), __ldg(cb + k + 1), __ldg(cb + k + 2), 0.0f);
    if constexpr (NASP) {
      const float m0 = __ldg(nb + k), m1 = __ldg(nb + k + 1), m2 = __ldg(nb + k + 2);
      const bool valid = (m0 != -1.0f) && (m1 != -1.0f) && (m2 != -1.0f);
      sn[i] = make_float4(m0, m1, m2, valid ? 1.0f : 0.0f);
    }
  }
  __syncthreads();

  const int x = bx + threadIdx.x;
  const int y0 = by + threadIdx.y * P;
  if (x >= W || y0 >= H) return;
  const int t0 = (threadIdx.y * P + R) * SW + threadIdx.x + R;  // pixel 0's own
  float4 a[P], n[P];
  float sum_g[P];
  int count[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    a[i] = sc[t0 + i * SW];
    if constexpr (NASP) n[i] = sn[t0 + i * SW];
    sum_g[i] = 0.0f;
    count[i] = 0;
  }

#pragma unroll
  for (int yy = -R; yy < P + R; ++yy) {
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const float4 q = sc[t0 + yy * SW + dx];
      float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if constexpr (NASP) m = sn[t0 + yy * SW + dx];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int dy = yy - i;
        if (dy < -R || dy > R) continue;
        const float d0 = a[i].x - q.x, d1 = a[i].y - q.y, d2 = a[i].z - q.z;
        float g = sqrtf((d0 * d0 + d1 * d1) + d2 * d2);
        if constexpr (NASP) {
          const bool both = (n[i].w != 0.0f) && (m.w != 0.0f);
          const float ndiff = fabsf((n[i].x * m.x + n[i].y * m.y) + n[i].z * m.z);
          if (both) g = g * (1.0f - ndiff);
        }
        sum_g[i] = sum_g[i] + g;
        count[i] += (g > 0.0f) ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (y0 + i >= H) break;
    // count is a small integer: as a float it is the plain version's count
    out[base + static_cast<size_t>(y0 + i) * W + x] =
        (count[i] > 0) ? sum_g[i] / static_cast<float>(count[i])
                       : __int_as_float(0x7f800000);
  }
}

template <bool NASP>
int launch(const float* color, const float* normals, float* out, int B, int H, int W,
           void* stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY * P - 1) / (TY * P), B);
  grad_kernel<NASP><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(color, normals, out,
                                                                          H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// color: [B, H, W, 3] f32; normals: [B, H, W, 3] f32 or null when nasp == 0;
// out: [B, H, W] f32.
extern "C" int kde_seed_gradient(const float* color, const float* normals,
                                 float* out, int B, int H, int W, int nasp,
                                 void* stream) {
  return nasp ? launch<true>(color, normals, out, B, H, W, stream)
              : launch<false>(color, normals, out, B, H, W, stream);
}
