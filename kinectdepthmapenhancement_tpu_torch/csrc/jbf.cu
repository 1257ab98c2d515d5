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
// Bound on the H100: instruction issue.  The bytes are one read of depth
// and guide and one write (~6 MB at 640x480), but every tap of both passes
// runs an IEEE division and a libdevice expf, which bitwise equality to the
// plain version keeps (-fmad=false, no fast math).
//
// Design: a thread computes P vertically adjacent output pixels of a TX x
// TY*P block tile; the tile and its R-pixel halo (zero outside the
// image) sit in shared memory as one float4 a pixel (g0, g1, g2, depth), so
// a tap is one 16-byte load.  The kernel is instantiated for each radius
// 0..8 and each pair of sigma gates.  The spatial table comes by value as a
// kernel parameter (the wrapper's cached copy of
// stencil.gaussian_spatial_filter, the plain version's bits), so a tap reads
// its spatial weight as a constant operand.  Up to CACHE_MAX_R the taps are
// unrolled and pass 1 keeps each tap's spatial x colour weight in registers
// for pass 2, which then adds only the depth factor (one expf and one
// division a tap); beyond it, pass 2 recomputes the weight, with the same
// bits.  Every operation rounds as the plain version's: the
// (e0 e0 + e1 e1) + e2 e2 association, the dy-outer tap order, IEEE
// division, libdevice expf.  Each weight factor and product flushes
// subnormals to 0 explicitly, as XLA does on the CPU and the TPU (the plain
// version's stencil.flush_subnormal); the build does not use -ftz, which the
// plain version could not follow.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;    // block width, threads
constexpr int TY = 8;     // block height, threads
constexpr int P = 1;      // vertically adjacent output pixels a thread
// resident blocks an SM that ptxas must allow: 6 caps the R = 2 kernel at
// 40 registers (48 warps an SM instead of 40 at its own 45)
constexpr int MIN_BLOCKS = 6;
constexpr int MAX_R = 8;  // the largest radius the entry point takes
constexpr int CACHE_MAX_R = 3;  // largest radius whose pass-1 weights stay in registers
constexpr float VALID_DEPTH_MM = 50.0f;

struct Spatial {
  float w[(2 * MAX_R + 1) * (2 * MAX_R + 1)];  // row-major [2R+1, 2R+1]
};

__device__ __forceinline__ float flush(float x) { return x < FLT_MIN ? 0.0f : x; }

// the spatial x colour weight of a tap, before the validity test
template <bool COLOR>
__device__ __forceinline__ float color_weight(float spatial, float4 c, float4 q,
                                              float color_c2) {
  if constexpr (COLOR) {
    const float e0 = c.x - q.x, e1 = c.y - q.y, e2 = c.z - q.z;
    const float cd = (e0 * e0 + e1 * e1) + e2 * e2;
    return flush(spatial * flush(expf(-cd / color_c2)));
  } else {
    return spatial;
  }
}

template <int R, bool COLOR, bool DEPTH>
__global__ void __launch_bounds__(TX * TY, MIN_BLOCKS)
jbf_kernel(const float* __restrict__ depth, const float* __restrict__ guide,
           const __grid_constant__ Spatial sp, float* __restrict__ out, int H,
           int W, float color_c2, float depth_c2) {
  constexpr int WIN = 2 * R + 1;
  constexpr int SW = TX + 2 * R, SH = TY * P + 2 * R;
  constexpr bool CACHE = R <= CACHE_MAX_R;
  __shared__ float4 tile[SH * SW];

  const int b = blockIdx.z;
  const int bx = blockIdx.x * TX, by = blockIdx.y * TY * P;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const float* db = depth + static_cast<size_t>(b) * H * W;
  const float* gb = guide + static_cast<size_t>(b) * H * W * 3;
  for (int i = tid; i < SH * SW; i += TX * TY) {
    const int yy = by - R + i / SW, xx = bx - R + i % SW;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const size_t p = static_cast<size_t>(yy) * W + xx;
      v = make_float4(gb[3 * p], gb[3 * p + 1], gb[3 * p + 2], db[p]);
    }
    tile[i] = v;
  }
  __syncthreads();

  const int x = bx + threadIdx.x;
  const int y0 = by + threadIdx.y * P;
  if (x >= W || y0 >= H) return;
  const float4* t = tile + (threadIdx.y * P + R) * SW + threadIdx.x + R;  // pixel 0's own
  float4 c[P];
#pragma unroll
  for (int i = 0; i < P; ++i) c[i] = t[i * SW];

  // pass 1: spatial x colour weighted mean of valid depth.  The thread walks
  // the window rows of its P pixels once; each pixel adds its taps dy outer,
  // dx inner.
  float cw[P][CACHE ? WIN * WIN : 1];
  float wsum[P], dsum[P];
#pragma unroll
  for (int i = 0; i < P; ++i) wsum[i] = dsum[i] = 0.0f;
#pragma unroll(R <= CACHE_MAX_R ? 2 * R + P : 1)
  for (int yy = -R; yy < R + P; ++yy) {
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const float4 q = t[yy * SW + dx];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int dy = yy - i;
        if (dy < -R || dy > R) continue;
        const int k = (dy + R) * WIN + dx + R;
        const float w = color_weight<COLOR>(sp.w[k], c[i], q, color_c2);
        if constexpr (CACHE) cw[i][k] = w;
        const float filt = (q.w > VALID_DEPTH_MM) ? w : 0.0f;
        dsum[i] = dsum[i] + q.w * filt;
        wsum[i] = wsum[i] + filt;
      }
    }
  }
  float mean[P];
#pragma unroll
  for (int i = 0; i < P; ++i) mean[i] = dsum[i] / ((wsum[i] > 0.0f) ? wsum[i] : 1.0f);

  // pass 2: x depth Gaussian against the pass-1 mean
  float num[P], den[P];
#pragma unroll
  for (int i = 0; i < P; ++i) num[i] = den[i] = 0.0f;
#pragma unroll(R <= CACHE_MAX_R ? 2 * R + P : 1)
  for (int yy = -R; yy < R + P; ++yy) {
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const float nd = t[yy * SW + dx].w;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int dy = yy - i;
        if (dy < -R || dy > R) continue;
        const int k = (dy + R) * WIN + dx + R;
        float filt;
        if constexpr (CACHE) {
          filt = cw[i][k];
        } else {
          filt = color_weight<COLOR>(sp.w[k], c[i], t[yy * SW + dx], color_c2);
        }
        if constexpr (DEPTH) {
          const float e = nd - mean[i];
          filt = flush(filt * flush(expf(-(e * e) / depth_c2)));
        }
        filt = (nd > VALID_DEPTH_MM) ? filt : 0.0f;
        num[i] = num[i] + nd * filt;
        den[i] = den[i] + filt;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (y0 + i >= H) break;
    const float o = (den[i] != 0.0f) ? num[i] / ((den[i] != 0.0f) ? den[i] : 1.0f) : 0.0f;
    out[static_cast<size_t>(b) * H * W + static_cast<size_t>(y0 + i) * W + x] =
        (wsum[i] > 0.0f) ? o : 0.0f;
  }
}

struct Args {
  const float* depth;
  const float* guide;
  float* out;
  int B, H, W;
  float color_c2, depth_c2;
  cudaStream_t stream;
};

template <int R, bool COLOR, bool DEPTH>
int run(const Args& a, const Spatial& sp) {
  dim3 block(TX, TY);
  dim3 grid((a.W + TX - 1) / TX, (a.H + TY * P - 1) / (TY * P), a.B);
  jbf_kernel<R, COLOR, DEPTH><<<grid, block, 0, a.stream>>>(
      a.depth, a.guide, sp, a.out, a.H, a.W, a.color_c2, a.depth_c2);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int run_gated(const Args& a, const Spatial& sp, bool color, bool depth) {
  if (color) return depth ? run<R, true, true>(a, sp) : run<R, true, false>(a, sp);
  return depth ? run<R, false, true>(a, sp) : run<R, false, false>(a, sp);
}

}  // namespace

// depth: [B, H, W] f32 mm; guide: [B, H, W, 3] f32 (device); spatial:
// [(2r+1)^2] f32 on the HOST, the spatial table row-major (passed to the
// kernel by value); out: [B, H, W] f32 (device).  0 <= r <= 8.
// color_c2 = 2 sigma_c^2, depth_c2 = 2 sigma_d^2.
extern "C" int kde_jbf(const float* depth, const float* guide, const float* spatial,
                       float* out, int B, int H, int W, int r, float color_c2,
                       float depth_c2, int use_color, int use_depth, void* stream) {
  if (r < 0 || r > MAX_R) return static_cast<int>(cudaErrorInvalidValue);
  Spatial sp = {};
  const int win = 2 * r + 1;
  for (int i = 0; i < win * win; ++i) sp.w[i] = spatial[i];
  const Args a{depth, guide, out, B, H, W, color_c2, depth_c2,
               static_cast<cudaStream_t>(stream)};
  const bool c = use_color != 0, d = use_depth != 0;
  switch (r) {
    case 0: return run_gated<0>(a, sp, c, d);
    case 1: return run_gated<1>(a, sp, c, d);
    case 2: return run_gated<2>(a, sp, c, d);
    case 3: return run_gated<3>(a, sp, c, d);
    case 4: return run_gated<4>(a, sp, c, d);
    case 5: return run_gated<5>(a, sp, c, d);
    case 6: return run_gated<6>(a, sp, c, d);
    case 7: return run_gated<7>(a, sp, c, d);
    default: return run_gated<8>(a, sp, c, d);
  }
}
