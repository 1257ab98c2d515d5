// Chamfer distance transform: rounds of 3x3 min-plus relaxation.
//
// Replaces the TPU kernel kinectdepthmapenhancement_tpu/ops/pallas_dt.py
// (distance_transform / _dt_kernel), which keeps the whole image resident in
// VMEM and runs every relaxation round in one launch.
//
// Bound on the H100: neither the bytes (one read of the i32 depth-change
// map, one write of the f32 result) nor the min/add arithmetic, but the
// chain of rounds: round t needs all of round t-1, so a block that owns a
// tile must either meet its neighbours between rounds or recompute a halo
// as deep as the rounds it runs.
//
// Design: one launch for up to HALO rounds (the wrapper chunks more), and
// one device activity per chunk: the first chunk forms the init (0 where
// dci == 0, w + h elsewhere) as it loads the i32 map, later chunks load the
// f32 result of the chunk before.  Each block owns a TW x TH output tile
// and keeps the tile plus a halo of R = rounds pixels in shared memory,
// twice: round t reads one buffer and writes the other (Jacobi, so the
// result after k rounds is exactly the plain version's), and one
// __syncthreads_or a round both publishes the round and reports whether any
// cell changed.  Round t computes only the cells within R - t of the tile:
// they read neighbours within R - t + 1, all of which round t - 1 computed,
// and no cell farther out can still reach the tile, so the region shrinks
// by one ring a round and needs no border of its own.  Cells outside the
// image are +inf in both buffers and never written (each round's rows and
// columns are clamped to the image once).  Threads sit at fixed columns,
// 32 lanes across, and each walks a run of consecutive rows, keeping the
// three rows around its cell in registers: three shared loads a cell.
// min(a + c, b + c) == min(a, b) + c exactly (rounding is monotone), so a
// cell is min(self, min of its 4 edge neighbours + 1, min of its 4 corner
// neighbours + 1.4), bitwise the plain version's 8 min-plus steps.  A round
// in which no cell of the block changed is a fixed point of every later
// round, so the block stops there.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 64;    // tile width
constexpr int TH = 32;    // tile height
constexpr int HALO = 26;  // most rounds one launch runs
constexpr int BX = 32;    // threads across (one warp: one row segment)
constexpr int BY = 16;    // warps, each over its own run of rows
constexpr int NT = BX * BY;

constexpr size_t smem_bytes(int rounds) {
  return 2 * sizeof(float) * (TW + 2 * rounds) * (TH + 2 * rounds);
}

template <bool FROM_DCI>
__global__ void __launch_bounds__(NT)
dt_kernel(const void* __restrict__ src, float* __restrict__ out, int H, int W,
          int rounds) {
  extern __shared__ float smem[];
  const int R = rounds;
  const int RW = TW + 2 * R, RH = TH + 2 * R;  // the region, pitch RW
  float* cur = smem;
  float* nxt = smem + RW * RH;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH - R, x0 = blockIdx.x * TW - R;
  const size_t plane = static_cast<size_t>(H) * W;
  const float inf = __int_as_float(0x7f800000);
  const float init_far = static_cast<float>(W + H);  // the init away from zeros

  for (int ly = ty; ly < RH; ly += BY) {
    const int yy = y0 + ly;
    for (int lx = tx; lx < RW; lx += BX) {
      const int xx = x0 + lx;
      float val = inf;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const size_t g = b * plane + static_cast<size_t>(yy) * W + xx;
        if (FROM_DCI) {
          val = static_cast<const int*>(src)[g] == 0 ? 0.0f : init_far;
        } else {
          val = static_cast<const float*>(src)[g];
        }
      }
      cur[ly * RW + lx] = val;
      nxt[ly * RW + lx] = val;
    }
  }
  __syncthreads();

  // the region's rows and columns inside the image
  const int iy0 = max(0, -y0), iy1 = min(RH - 1, H - 1 - y0);
  const int ix0 = max(0, -x0), ix1 = min(RW - 1, W - 1 - x0);
  for (int t = 1; t <= R; ++t) {
    // cells within R - t of the tile, inside the image
    const int r0 = max(t, iy0), r1 = min(RH - 1 - t, iy1);
    const int c0 = max(t, ix0), c1 = min(RW - 1 - t, ix1);
    const int seg = (r1 - r0 + BY) / BY;  // rows per warp, balanced
    const int ra = r0 + ty * seg, rb = min(ra + seg - 1, r1);
    int changed = 0;
    if (ra <= rb) {
      for (int cx = c0 + tx; cx <= c1; cx += BX) {
        const float* p = cur + (ra - 1) * RW + cx;
        float ul = p[-1], uc = p[0], ur = p[1];
        p += RW;
        float ml = p[-1], mc = p[0], mr = p[1];
        float* q = nxt + ra * RW + cx;
#pragma unroll 4
        for (int r = ra; r <= rb; ++r) {
          p += RW;
          const float dl = p[-1], dc = p[0], dr = p[1];
          const float edge = fminf(fminf(uc, dc), fminf(ml, mr)) + 1.0f;
          const float corner = fminf(fminf(ul, ur), fminf(dl, dr)) + 1.4f;
          const float best = fminf(mc, fminf(edge, corner));
          changed |= best != mc;
          *q = best;
          q += RW;
          ul = ml;
          uc = mc;
          ur = mr;
          ml = dl;
          mc = dc;
          mr = dr;
        }
      }
    }
    const int any = __syncthreads_or(changed);
    float* swap = cur;
    cur = nxt;
    nxt = swap;
    if (!any) break;  // a fixed point: every later round is a no-op
  }

  float* dst = out + b * plane;
  for (int ly = ty; ly < TH; ly += BY) {
    const int yy = blockIdx.y * TH + ly;
    if (yy >= H) break;
    for (int lx = tx; lx < TW; lx += BX) {
      const int xx = blockIdx.x * TW + lx;
      if (xx < W) dst[static_cast<size_t>(yy) * W + xx] = cur[(R + ly) * RW + R + lx];
    }
  }
}

constexpr int MAX_DEVICES = 64;

// Dynamic shared memory above 48 KB must be allowed per kernel and device:
// allow the most any call asks (HALO rounds) once, at the first launch on
// each device, so later launches make no driver call for it.
template <bool FROM_DCI>
cudaError_t allow_smem() {
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev < MAX_DEVICES;
  if (known && allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(dt_kernel<FROM_DCI>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes(HALO)));
  if (e == cudaSuccess && known) allowed[dev] = true;
  return e;
}

template <bool FROM_DCI>
int launch(const void* src, float* out, int B, int H, int W, int rounds,
           void* stream) {
  const cudaError_t e = allow_smem<FROM_DCI>();
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  dim3 block(BX, BY);
  dt_kernel<FROM_DCI><<<grid, block, smem_bytes(rounds),
                        static_cast<cudaStream_t>(stream)>>>(src, out, H, W, rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: [B, H, W], i32 dci when from_dci (the init is formed on load), else
// the f32 result of an earlier chunk; out: [B, H, W] f32 (device).
// 0 <= rounds <= kde_dt_max_rounds(); 0 rounds writes the init.
extern "C" int kde_dt(const void* src, int from_dci, float* out, int B, int H,
                      int W, int rounds, void* stream) {
  if (rounds < 0 || rounds > HALO) return static_cast<int>(cudaErrorInvalidValue);
  return from_dci ? launch<true>(src, out, B, H, W, rounds, stream)
                  : launch<false>(src, out, B, H, W, rounds, stream);
}

extern "C" int kde_dt_max_rounds() { return HALO; }
