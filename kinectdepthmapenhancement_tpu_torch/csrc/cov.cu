// Per-pixel covariance pyramid for CM normals.
//
// Replaces the TPU kernel kinectdepthmapenhancement_tpu/ops/pallas_cov.py
// (cm_covariances -> _cm_covariances_batched / _cov_kernel).  For each pixel
// it accumulates the valid neighbours of the nested reference windows
// (sizes 2..21, NormalMapGenerator.cu:244-302) centred on the pixel's own
// vertex, and keeps the (count, 6 covariance entries) snapshot of the size
// its smoothing map selects.
//
// Bound on the H100: FLOPs.  441 taps x ~22 f32 operations per pixel is
// ~2.7 GFLOP per 640x480 frame against 4 MB of input; written as PyTorch
// ops the same sweep is ~10^4 launches that each stream the whole image
// through device memory.
//
// Design: one thread per pixel.  The block's 32x8 pixels plus a 10-pixel
// halo of the vertex map sit in shared memory (structure of arrays, 17.5 KB);
// each thread keeps its 10 running sums and 7 outputs in registers and walks
// the taps in _ring_taps order (per size, the new taps sorted by (dy, dx)),
// snapshotting after each size exactly as pallas_cov.py:91-115 does.  Built
// with -fmad=false, every operation rounds as the plain PyTorch version's,
// so the output is bitwise equal to it.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_RECT = 21;
constexpr int MAX_R = MAX_RECT >> 1;  // 10
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int SW = TX + 2 * MAX_R;
constexpr int SH = TY + 2 * MAX_R;

__global__ void __launch_bounds__(TX * TY)
cov_kernel(const float* __restrict__ v, const int* __restrict__ rect,
           float* __restrict__ cnt_out, float* __restrict__ cov_out, int H,
           int W) {
  __shared__ float sx[SH * SW];
  __shared__ float sy[SH * SW];
  __shared__ float sz[SH * SW];
  const int b = blockIdx.z;
  const int bx = blockIdx.x * TX, by = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const float* vb = v + static_cast<size_t>(b) * H * W * 3;

  for (int i = tid; i < SH * SW; i += TX * TY) {
    const int yy = by - MAX_R + i / SW, xx = bx - MAX_R + i % SW;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float* p = vb + (static_cast<size_t>(yy) * W + xx) * 3;
      px = p[0];
      py = p[1];
      pz = p[2];
    }
    sx[i] = px;
    sy[i] = py;
    sz[i] = pz;
  }
  __syncthreads();

  const int x = bx + threadIdx.x, y = by + threadIdx.y;
  if (x >= W || y >= H) return;

  const int c = (threadIdx.y + MAX_R) * SW + threadIdx.x + MAX_R;
  const float a0 = sx[c], a1 = sy[c], a2 = sz[c];
  const size_t pix = (static_cast<size_t>(b) * H + y) * W + x;
  const int rc = rect[pix];

  float cnt = 0.0f;
  float s10 = 0.0f, s11 = 0.0f, s12 = 0.0f;
  float s20 = 0.0f, s21 = 0.0f, s22 = 0.0f, s23 = 0.0f, s24 = 0.0f, s25 = 0.0f;
  float oc = 0.0f;
  float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, o3 = 0.0f, o4 = 0.0f, o5 = 0.0f;

  for (int s = 2; s <= MAX_RECT; ++s) {
    // window(s) = [-(s>>1), -(s>>1)+s-1]^2; window(s-1) is nested inside it
    const int lo = -(s >> 1), hi = lo + s - 1;
    const int plo = -((s - 1) >> 1), phi = plo + s - 2;
    for (int dy = lo; dy <= hi; ++dy) {
      for (int dx = lo; dx <= hi; ++dx) {
        if (s > 2 && dy >= plo && dy <= phi && dx >= plo && dx <= phi) continue;
        const int k = c + dy * SW + dx;
        const float m = (sz[k] != 0.0f) ? 1.0f : 0.0f;
        const float r0 = (sx[k] - a0) * m;
        const float r1 = (sy[k] - a1) * m;
        const float r2 = (sz[k] - a2) * m;
        cnt = cnt + m;
        s10 = s10 + r0;
        s11 = s11 + r1;
        s12 = s12 + r2;
        s20 = s20 + r0 * r0;
        s21 = s21 + r0 * r1;
        s22 = s22 + r0 * r2;
        s23 = s23 + r1 * r1;
        s24 = s24 + r1 * r2;
        s25 = s25 + r2 * r2;
      }
    }
    const bool sel = (s == MAX_RECT) ? (rc >= s) : (rc == s);
    if (sel) {
      const float n = fmaxf(cnt, 1.0f);
      oc = cnt;
      o0 = s20 - (s10 * s10) / n;
      o1 = s21 - (s10 * s11) / n;
      o2 = s22 - (s10 * s12) / n;
      o3 = s23 - (s11 * s11) / n;
      o4 = s24 - (s11 * s12) / n;
      o5 = s25 - (s12 * s12) / n;
    }
  }

  cnt_out[pix] = oc;
  float* o = cov_out + pix * 6;
  o[0] = o0;
  o[1] = o1;
  o[2] = o2;
  o[3] = o3;
  o[4] = o4;
  o[5] = o5;
}

}  // namespace

// v: [B, H, W, 3] f32 metres (z == 0 invalid); rect: [B, H, W] i32;
// cnt: [B, H, W] f32; cov: [B, H, W, 6] f32 (xx, xy, xz, yy, yz, zz).
extern "C" int kde_cov(const float* v, const int* rect, float* cnt, float* cov,
                       int B, int H, int W, void* stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  cov_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(v, rect, cnt,
                                                                    cov, H, W);
  return static_cast<int>(cudaGetLastError());
}
