// Per-pixel covariance pyramid for CM normals.
//
// Replaces the TPU kernel kinectdepthmapenhancement_tpu/ops/pallas_cov.py
// (cm_covariances -> _cm_covariances_batched / _cov_kernel).  For each pixel
// it accumulates the valid neighbours of the nested reference windows
// (sizes 2..21, NormalMapGenerator.cu:244-302) centred on the pixel's own
// vertex, and keeps the (count, 6 covariance entries) snapshot of the size
// its smoothing map selects.
//
// Bound on the H100: f32 issue.  A pixel needs min(rect, 21)^2 taps of
// about 22 f32 operations each (2.6 G per 640x480 frame of the KDE path,
// against 4 MB of input); the sums must be centred on the pixel and taken
// in ring order to stay bitwise equal to the plain version, so tensor cores
// do not apply, and with -fmad=false every add and multiply issues on its
// own.
//
// Design: one thread per pixel.  The block's 32x8 pixels plus a 10-pixel
// halo of the vertex map sit in shared memory, loaded once, as float4
// (x, y, z, valid), 23 KB: one 16-byte load a tap, and the validity factor
// m = (z != 0) formed once per vertex instead of once per tap.  Each thread
// keeps its 10 running sums in registers and walks the rings of
// ring_taps() directly, with no tap tested and skipped: going
// from size s-1 to size s adds one row and one column of the window
// [lo, hi]^2, lo = -(s >> 1), hi = lo + s - 1,
//   even s: the row dy = lo (dx = lo..hi), then the column dx = lo
//           (dy = lo+1..hi);
//   odd s:  the column dx = hi (dy = lo..hi-1), then the row dy = hi
//           (dx = lo..hi);
// and size 2, whose ring is the whole 2x2 window, adds the centre tap last.
// That is each ring sorted by (dy, dx), walked by a shared-memory index with
// stride 1 along a row and SW down a column: 441 iterations at most, where
// testing every tap of every window took 3310.  A pixel stops after its own
// size, min(rect, 21) (no later size changes its snapshot), and one with
// rect < 2 writes zeros.  Built with -fmad=false, every operation rounds as
// the plain PyTorch version's, so the output is bitwise equal to it.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_RECT = 21;
constexpr int MAX_R = MAX_RECT >> 1;  // 10
constexpr int TX = 32;
constexpr int TY = 8;
constexpr int SW = TX + 2 * MAX_R;
constexpr int SH = TY + 2 * MAX_R;

struct Acc {
  float a0, a1, a2;  // the centre vertex
  float cnt = 0.0f;
  float s10 = 0.0f, s11 = 0.0f, s12 = 0.0f;
  float s20 = 0.0f, s21 = 0.0f, s22 = 0.0f, s23 = 0.0f, s24 = 0.0f, s25 = 0.0f;

  __device__ __forceinline__ void tap(const float4* s, int k) {
    const float4 q = s[k];
    const float m = q.w;
    const float r0 = (q.x - a0) * m;
    const float r1 = (q.y - a1) * m;
    const float r2 = (q.z - a2) * m;
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

  // n taps from shared-memory index k, STRIDE apart (1: a row, SW: a column)
  template <int STRIDE>
  __device__ __forceinline__ void side(const float4* s, int k, int n) {
#pragma unroll 4
    for (int i = 0; i < n; ++i, k += STRIDE) tap(s, k);
  }
};

__global__ void __launch_bounds__(TX * TY)
cov_kernel(const float* __restrict__ v, const int* __restrict__ rect,
           float* __restrict__ cnt_out, float* __restrict__ cov_out, int H,
           int W) {
  __shared__ float4 s[SH * SW];
  const int b = blockIdx.z;
  const int bx = blockIdx.x * TX, by = blockIdx.y * TY;
  const float* vb = v + static_cast<size_t>(b) * H * W * 3;

  for (int ly = threadIdx.y; ly < SH; ly += TY) {
    const int yy = by - MAX_R + ly;
    for (int lx = threadIdx.x; lx < SW; lx += TX) {
      const int xx = bx - MAX_R + lx;
      float px = 0.0f, py = 0.0f, pz = 0.0f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const float* p = vb + (static_cast<size_t>(yy) * W + xx) * 3;
        px = p[0];
        py = p[1];
        pz = p[2];
      }
      s[ly * SW + lx] = make_float4(px, py, pz, (pz != 0.0f) ? 1.0f : 0.0f);
    }
  }
  __syncthreads();

  const int x = bx + threadIdx.x, y = by + threadIdx.y;
  if (x >= W || y >= H) return;

  const int c = (threadIdx.y + MAX_R) * SW + threadIdx.x + MAX_R;
  const size_t pix = (static_cast<size_t>(b) * H + y) * W + x;
  const int smax = min(rect[pix], MAX_RECT);

  float oc = 0.0f;
  float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, o3 = 0.0f, o4 = 0.0f, o5 = 0.0f;
  if (smax >= 2) {
    Acc a;
    a.a0 = s[c].x;
    a.a1 = s[c].y;
    a.a2 = s[c].z;
    for (int m = 1;; ++m) {
      // even s = 2m, window [-m, m-1]: the row dy = -m, then the column dx = -m
      const int corner = c - m * SW - m;
      a.side<1>(s, corner, 2 * m);
      a.side<SW>(s, corner + SW, 2 * m - 1);
      if (m == 1) a.tap(s, c);  // size 2's ring is its whole window
      if (2 * m == smax) break;
      // odd s = 2m+1, window [-m, m]: the column dx = m, then the row dy = m
      a.side<SW>(s, c - m * SW + m, 2 * m);
      a.side<1>(s, c + m * SW - m, 2 * m + 1);
      if (2 * m + 1 == smax) break;
    }
    const float n = fmaxf(a.cnt, 1.0f);
    oc = a.cnt;
    o0 = a.s20 - (a.s10 * a.s10) / n;
    o1 = a.s21 - (a.s10 * a.s11) / n;
    o2 = a.s22 - (a.s10 * a.s12) / n;
    o3 = a.s23 - (a.s11 * a.s11) / n;
    o4 = a.s24 - (a.s11 * a.s12) / n;
    o5 = a.s25 - (a.s12 * a.s12) / n;
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
