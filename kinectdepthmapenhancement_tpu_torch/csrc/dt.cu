// Chamfer distance transform: rounds of 3x3 min-plus relaxation.
//
// Replaces the TPU kernel kinectdepthmapenhancement_tpu/ops/pallas_dt.py
// (distance_transform / _dt_kernel), which keeps the whole image resident in
// VMEM and runs every relaxation round in one launch.
//
// Bound on the H100: neither bytes nor FLOPs of the arithmetic itself (one
// read and one write of a 1.2 MB f32 image, ~16 min/add per pixel per round)
// but the round count: done as separate PyTorch ops, each of the 26 rounds
// is 8 pad + add + min launches over the whole image, so the stage is
// launch- and memory-round-trip bound.
//
// Design: one launch for all rounds.  Each block owns a 32x32 output tile
// plus a halo as deep as the rounds it runs, resident in shared memory
// (84x84 f32 = 28 KB for 26 rounds).  A round reads the neighbours from
// shared memory into registers, synchronises, and writes back (Jacobi, so
// the result after k rounds is exactly the XLA relaxation's).  Cells outside
// the region are treated as +inf; that error moves inwards one pixel per
// round and never reaches the tile.  Cells outside the image stay +inf.
// min and + are exact in f32 and the per-path additions happen in the same
// order, so the output is bitwise equal to the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 26;  // most rounds one launch runs
constexpr int REG = TILE + 2 * HALO;
constexpr int NT = 256;
constexpr int PER = (REG * REG + NT - 1) / NT;

__global__ void __launch_bounds__(NT)
dt_kernel(const float* __restrict__ init, float* __restrict__ out, int H, int W,
          int rounds) {
  __shared__ float s[REG * REG];
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE - HALO;
  const int x0 = blockIdx.x * TILE - HALO;
  const float* src = init + static_cast<size_t>(b) * H * W;
  const float inf = __int_as_float(0x7f800000);

  for (int i = threadIdx.x; i < REG * REG; i += NT) {
    const int yy = y0 + i / REG, xx = x0 + i % REG;
    const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
    s[i] = in ? src[static_cast<size_t>(yy) * W + xx] : inf;
  }
  __syncthreads();

  const int ndy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int ndx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
  const float ncost[8] = {1.4f, 1.0f, 1.4f, 1.0f, 1.0f, 1.4f, 1.0f, 1.4f};

  for (int t = 0; t < rounds; ++t) {
    float nv[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * NT;
      if (i < REG * REG) {
        const int ly = i / REG, lx = i % REG;
        const int yy = y0 + ly, xx = x0 + lx;
        float best = s[i];
        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int ny = ly + ndy[j], nx = lx + ndx[j];
            if (ny >= 0 && ny < REG && nx >= 0 && nx < REG) {
              best = fminf(best, s[ny * REG + nx] + ncost[j]);
            }
          }
        }
        nv[k] = best;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * NT;
      if (i < REG * REG) s[i] = nv[k];
    }
    __syncthreads();
  }

  float* dst = out + static_cast<size_t>(b) * H * W;
  for (int i = threadIdx.x; i < TILE * TILE; i += NT) {
    const int ly = HALO + i / TILE, lx = HALO + i % TILE;
    const int yy = y0 + ly, xx = x0 + lx;
    if (yy < H && xx < W) dst[static_cast<size_t>(yy) * W + xx] = s[ly * REG + lx];
  }
}

}  // namespace

// init, out: [B, H, W] f32 (device).  rounds <= kde_dt_max_rounds().
extern "C" int kde_dt(const float* init, float* out, int B, int H, int W,
                      int rounds, void* stream) {
  if (rounds < 0 || rounds > HALO) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  dt_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(init, out, H, W,
                                                                rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kde_dt_max_rounds() { return HALO; }
