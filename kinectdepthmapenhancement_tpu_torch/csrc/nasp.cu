// NASP cell kernels: label-cell gather, label-cell sums, NASP update sums
// and the fused first assignment + analyze sums.
//
// Replace the TPU kernels of kinectdepthmapenhancement_tpu/ops/pallas_nasp.py:
//   kde_label_cell_gather    label_cell_gather        (:340, body :301)
//   kde_label_cell_sums      label_cell_sums          (:224, body :183)
//   kde_nasp_cell_sums       nasp_cell_sums           (:654, body :63)
//   kde_nasp_assign_analyze  nasp_assign_and_analyze  (:554, body :400)
//
// Single-iteration NASP labels are cell-local: a pixel of grid cell (cy, cx)
// carries -1 or cluster (cy + dy) * cols + (cx + dx), (dy, dx) in [-r, r)^2.
// So a label's candidate slot follows arithmetically,
// j = (dy + r) * 2r + (dx + r); the TPU's 64-way select chains over rolled
// lane maps become one index.
//
// Bound on the H100: memory.  At 640x480 each kernel reads the image planes
// once (~4-15 MB) and writes a small [B, rows*cols*n, F] partial table; the
// assignment's 64 candidates x ~35 flops per pixel are ~0.7 GFLOP, a few
// microseconds of f32 issue.  The plain PyTorch versions are bound instead
// by launches and by the [P, n] one-hot products.
//
// Design: one 256-thread block per (frame, cell) for the sums.  The cell's
// pixels are staged in chunks of 256 in shared memory (candidate slot + F
// features each); thread t owns outputs (slot, feature) o = t + 256k and
// walks the chunk in pixel order, adding matching features into a double.
// No atomics of any kind: each sum has one owner and a fixed order, and a
// double sum of f32 terms is exact for integer-valued features (counts,
// colours, u, v) and within 1 ulp of the exact sum for the rest.  The
// assignment keeps the plain version's operation order (built with
// -fmad=false, IEEE sqrtf and division) and candidates dy-major with a strict
// <, so labels and distances are bitwise equal to it.  The weighted
// features flush subnormal weights to 0 as XLA does (stencil.flush_subnormal
// in the plain version).  The gather is one thread per pixel and only copies.

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads per sums block
constexpr int CH = 256;        // pixels staged per chunk
constexpr int KO = 4;          // outputs a thread owns per pass
constexpr int MAXF = 16;       // most features a sums kernel stages per pixel
constexpr int MAXN = 64;       // most candidates of the fused assignment (r <= 4)
constexpr int N_ANALYZE = 13;
constexpr int N_WEIGHTED = 14;
constexpr float VALID_DEPTH_MM = 50.0f;
constexpr float INVALID_NORMAL = -1.0f;
constexpr float INIT_DISTANCE = 999999.9f;  // the JAX package's slic.INIT_DISTANCE in f32

struct Cells {
  int H, W, rows, cols, r, bs_y, bs_x;
};

__device__ __forceinline__ float flush(float x) { return x < FLT_MIN ? 0.0f : x; }

// candidate slot of `label` in cell (cy, cx), -1 when it is not a candidate
__device__ __forceinline__ int slot_of(int label, int cy, int cx, const Cells& c) {
  if (label < 0 || label >= c.rows * c.cols) return -1;
  const int dy = label / c.cols - cy, dx = label % c.cols - cx;
  if (dy < -c.r || dy >= c.r || dx < -c.r || dx >= c.r) return -1;
  return (dy + c.r) * 2 * c.r + (dx + c.r);
}

__device__ __forceinline__ bool normal_valid(const float* n) {
  return n[0] != INVALID_NORMAL || n[1] != INVALID_NORMAL || n[2] != INVALID_NORMAL;
}

// The NASP update features of one pixel in the JAX package's feats order
// (slic.py:1182-1190 analyze, :1272-1282 weighted), written to f.  `cl`
// holds the pixel's cluster fields: x, y (and rgb 3, normal 3 when
// weighted).  Returns false outside the cluster's update window.
__device__ __forceinline__ bool nasp_features(bool weighted, float u, float v,
                                              const float* col, const float* pt,
                                              const float* nm, const float* cl,
                                              float lo, float hi, float c2, float s2,
                                              float* f) {
  const float dxp = u - cl[0], dyp = v - cl[1];
  if (!(dxp >= lo && dxp <= hi && dyp >= lo && dyp <= hi)) return false;
  const bool nvalid = normal_valid(nm);
  if (!weighted) {
    const float acc = (pt[2] > VALID_DEPTH_MM && nvalid) ? 1.0f : 0.0f;
    f[0] = col[0]; f[1] = col[1]; f[2] = col[2];
    f[3] = u; f[4] = v; f[5] = 1.0f;
    f[6] = pt[0] * acc; f[7] = pt[1] * acc; f[8] = pt[2] * acc;
    f[9] = nm[0] * acc; f[10] = nm[1] * acc; f[11] = nm[2] * acc;
    f[12] = acc;
    return true;
  }
  const float* c_rgb = cl + 2;
  const float* c_n = cl + 5;
  const float e0 = col[0] - c_rgb[0], e1 = col[1] - c_rgb[1], e2 = col[2] - c_rgb[2];
  const float cdiff = (e0 * e0 + e1 * e1) + e2 * e2;
  const float cfilt = flush(expf(-cdiff / c2));
  const float sdiff = dxp * dxp + dyp * dyp;
  const float sfilt = flush(expf(-sdiff / s2));
  const float wgt = flush(cfilt * sfilt);
  const float dot = (nm[0] * c_n[0] + nm[1] * c_n[1]) + nm[2] * c_n[2];
  const float dclamp = fmaxf(dot, 0.0f);
  const float acc = (pt[2] > VALID_DEPTH_MM && nvalid && dclamp > 0.5f && dclamp <= 1.0f)
                        ? 1.0f : 0.0f;
  f[0] = col[0] * wgt; f[1] = col[1] * wgt; f[2] = col[2] * wgt;
  f[3] = u * wgt; f[4] = v * wgt; f[5] = wgt;
  f[6] = pt[0] * acc; f[7] = pt[1] * acc; f[8] = pt[2] * acc;
  f[9] = nm[0] * acc; f[10] = nm[1] * acc; f[11] = nm[2] * acc;
  f[12] = dclamp * acc; f[13] = acc;
  return true;
}

// Per-(cell, candidate) sums of F features for the block's cell.  `load`
// (a functor) stages pixel p of the cell: writes its F features and returns
// its candidate slot (-1: the pixel adds nothing).  out: the cell's
// [n, F] rows of the [B, rows*cols*n, F] partial table.
template <class Loader>
__device__ void cell_sums(const Loader& load, const Cells& c, int F, int b, int cy,
                          int cx, float* out) {
  __shared__ int s_slot[CH];
  __shared__ float s_feat[CH * MAXF];
  const int n = 4 * c.r * c.r;
  const int nF = n * F;
  const int P = c.bs_y * c.bs_x;
  const int tid = threadIdx.x;
  float* ob = out + (static_cast<size_t>(b * c.rows + cy) * c.cols + cx) * nF;
  for (int o0 = 0; o0 < nF; o0 += NT * KO) {
    double acc[KO];
#pragma unroll
    for (int k = 0; k < KO; ++k) acc[k] = 0.0;
    for (int p0 = 0; p0 < P; p0 += CH) {
      const int np = min(CH, P - p0);
      for (int q = tid; q < np; q += NT) s_slot[q] = load(b, cy, cx, p0 + q, s_feat + q * F);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KO; ++k) {
        const int o = o0 + k * NT + tid;
        if (o < nF) {
          const int j = o / F, f = o % F;
          double a = acc[k];
          for (int q = 0; q < np; ++q) {
            if (s_slot[q] == j) a += static_cast<double>(s_feat[q * F + f]);
          }
          acc[k] = a;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < KO; ++k) {
      const int o = o0 + k * NT + tid;
      if (o < nF) ob[o] = static_cast<float>(acc[k]);
    }
  }
}

__device__ __forceinline__ size_t pixel_of(const Cells& c, int b, int cy, int cx, int p,
                                           int* y, int* x) {
  *y = cy * c.bs_y + p / c.bs_x;
  *x = cx * c.bs_x + p % c.bs_x;
  return (static_cast<size_t>(b) * c.H + *y) * c.W + *x;
}

struct LabelSumsLoader {
  const int* labels;
  const float* feats;  // [B, H, W, F]
  Cells c;
  int F;
  __device__ int operator()(int b, int cy, int cx, int p, float* f) const {
    int y, x;
    const size_t pix = pixel_of(c, b, cy, cx, p, &y, &x);
    const int slot = slot_of(labels[pix], cy, cx, c);
    if (slot < 0) return -1;
    for (int i = 0; i < F; ++i) f[i] = feats[pix * F + i];
    return slot;
  }
};

struct NaspSumsLoader {
  const int* labels;
  const float *color, *points, *normals;
  const float* cand;  // [B, rows*cols, nf]: x, y (, rgb 3, normal 3)
  Cells c;
  float lo, hi, c2, s2;
  int weighted;
  __device__ int operator()(int b, int cy, int cx, int p, float* f) const {
    int y, x;
    const size_t pix = pixel_of(c, b, cy, cx, p, &y, &x);
    const int label = labels[pix];
    const int slot = slot_of(label, cy, cx, c);
    if (slot < 0) return -1;
    const int nf = weighted ? 8 : 2;
    const float* cl = cand + (static_cast<size_t>(b) * c.rows * c.cols + label) * nf;
    const bool in = nasp_features(weighted != 0, static_cast<float>(x), static_cast<float>(y),
                                  color + 3 * pix, points + 3 * pix, normals + 3 * pix, cl,
                                  lo, hi, c2, s2, f);
    return in ? slot : -1;
  }
};

// The first NASP assignment of one pixel (calculateLD_NASP, the plain
// version's band-space sweep), then its analyze features.  The cell's
// candidate fields are staged in shared memory: s_id[j] (-9 outside the
// grid) and s_cand[j] = rgb 3, x, y, center z, normal 3.
struct AssignLoader {
  const float *color, *points, *normals;
  int* labels_out;
  float* dist_out;
  const int* s_id;
  const float (*s_cand)[9];
  Cells c;
  float lo, hi, w_col, w_spa, w_dep, w_nor, s2scale;
  int apply_invalid;
  __device__ int operator()(int b, int cy, int cx, int p, float* f) const {
    int y, x;
    const size_t pix = pixel_of(c, b, cy, cx, p, &y, &x);
    const float* col = color + 3 * pix;
    const float* pt = points + 3 * pix;
    const float* nm = normals + 3 * pix;
    const float u = static_cast<float>(x), v = static_cast<float>(y);
    const float zc = pt[2];
    const bool nv_pix = normal_valid(nm);
    const int own = cy * c.cols + cx;
    const int n = 4 * c.r * c.r;
    float bd = INFINITY;
    int bl = -1;
    for (int j = 0; j < n; ++j) {
      float cand_d = INIT_DISTANCE;
      int cand_l = own;
      if (s_id[j] >= 0) {
        const float* cf = s_cand[j];
        const float d0 = col[0] - cf[0], d1 = col[1] - cf[1], d2 = col[2] - cf[2];
        const float cd = (d0 * d0 + d1 * d1) + d2 * d2;
        const float ex = u - cf[3], ey = v - cf[4];
        const float pd = sqrtf(ex * ex + ey * ey) * s2scale;
        const bool zpair = zc > VALID_DEPTH_MM && cf[5] > VALID_DEPTH_MM;
        const float dd = zpair ? fabsf(zc - cf[5]) : 0.0f;
        float dist = (cd * w_col + pd * w_spa) + dd * w_dep;
        const bool npair = zpair && nv_pix && normal_valid(cf + 6);
        const float dot = (nm[0] * cf[6] + nm[1] * cf[7]) + nm[2] * cf[8];
        const float nd = npair ? 65025.0f * (1.0f - fmaxf(dot, 0.0f)) : 0.0f;
        dist = dist + nd * w_nor;
        cand_d = dist;
        cand_l = s_id[j];
      }
      if (cand_d < bd) {
        bd = cand_d;
        bl = cand_l;
      }
    }
    if (apply_invalid && zc < VALID_DEPTH_MM) {  // NormalAdaptiveSuperpixel.cu:346-352
      bl = -1;
      bd = 0.0f;
    }
    labels_out[pix] = bl;
    dist_out[pix] = bd;
    const int slot = slot_of(bl, cy, cx, c);
    if (slot < 0) return -1;
    const float cl[2] = {s_cand[slot][3], s_cand[slot][4]};
    return nasp_features(false, u, v, col, pt, nm, cl, lo, hi, 1.0f, 1.0f, f) ? slot : -1;
  }
};

__global__ void __launch_bounds__(NT)
label_sums_kernel(LabelSumsLoader ld, float* out) {
  cell_sums(ld, ld.c, ld.F, blockIdx.z, blockIdx.y, blockIdx.x, out);
}

__global__ void __launch_bounds__(NT)
nasp_sums_kernel(NaspSumsLoader ld, float* out) {
  cell_sums(ld, ld.c, ld.weighted ? N_WEIGHTED : N_ANALYZE, blockIdx.z, blockIdx.y,
            blockIdx.x, out);
}

__global__ void __launch_bounds__(NT)
assign_analyze_kernel(AssignLoader ld, const float* cand, float* out) {
  __shared__ int s_id[MAXN];
  __shared__ float s_cand[MAXN][9];
  const Cells& c = ld.c;
  const int b = blockIdx.z, cy = blockIdx.y, cx = blockIdx.x;
  const int n = 4 * c.r * c.r;
  for (int j = threadIdx.x; j < n; j += NT) {
    const int ny = cy + j / (2 * c.r) - c.r, nx = cx + j % (2 * c.r) - c.r;
    const bool ing = ny >= 0 && ny < c.rows && nx >= 0 && nx < c.cols;
    s_id[j] = ing ? ny * c.cols + nx : -9;
    const float* src = cand + (static_cast<size_t>(b) * c.rows * c.cols +
                               (ing ? ny * c.cols + nx : 0)) * 9;
    for (int i = 0; i < 9; ++i) s_cand[j][i] = ing ? src[i] : 0.0f;
  }
  __syncthreads();
  AssignLoader l = ld;
  l.s_id = s_id;
  l.s_cand = s_cand;
  cell_sums(l, c, N_ANALYZE, b, cy, cx, out);
}

__global__ void __launch_bounds__(NT)
label_gather_kernel(const int* labels, const float* table, float* out, int B, Cells c,
                    int F) {
  const size_t i = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<size_t>(B) * c.H * c.W) return;
  const int x = static_cast<int>(i % c.W);
  const int y = static_cast<int>((i / c.W) % c.H);
  const int b = static_cast<int>(i / (static_cast<size_t>(c.H) * c.W));
  const int label = labels[i];
  float* o = out + i * F;
  if (slot_of(label, y / c.bs_y, x / c.bs_x, c) < 0) {
    for (int f = 0; f < F; ++f) o[f] = 0.0f;
    return;
  }
  const float* row = table + (static_cast<size_t>(b) * c.rows * c.cols + label) * F;
  for (int f = 0; f < F; ++f) o[f] = row[f];
}

bool make_cells(int H, int W, int rows, int cols, int r, Cells* c) {
  if (H <= 0 || W <= 0 || rows <= 0 || cols <= 0 || r < 1) return false;
  if (H % rows != 0 || W % cols != 0) return false;
  *c = Cells{H, W, rows, cols, r, H / rows, W / cols};
  return true;
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// labels [B, H, W] i32; table [B, rows*cols, F] f32; out [B, H, W, F] f32.
extern "C" int kde_label_cell_gather(const int* labels, const float* table, float* out,
                                     int B, int H, int W, int rows, int cols, int r, int F,
                                     void* stream) {
  Cells c;
  if (B <= 0 || F <= 0 || !make_cells(H, W, rows, cols, r, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(B) * H * W;
  const unsigned blocks = static_cast<unsigned>((total + NT - 1) / NT);
  label_gather_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      labels, table, out, B, c, F);
  return launched();
}

// labels [B, H, W] i32; feats [B, H, W, F] f32 (pre-masked);
// out [B, rows*cols*(2r)^2, F] f32.
extern "C" int kde_label_cell_sums(const int* labels, const float* feats, float* out,
                                   int B, int H, int W, int rows, int cols, int r, int F,
                                   void* stream) {
  Cells c;
  if (B <= 0 || F <= 0 || F > MAXF || !make_cells(H, W, rows, cols, r, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  LabelSumsLoader ld{labels, feats, c, F};
  label_sums_kernel<<<dim3(cols, rows, B), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      ld, out);
  return launched();
}

// labels [B, H, W] i32; color, points, normals [B, H, W, 3] f32; cand
// [B, rows, cols, 2 | 8] f32 (x, y | x, y, rgb, normal); mode 0 analyze
// (13 features), 1 weighted (14); c2 = 2 sigma_c^2, s2 = 2 sigma_s^2;
// out [B, rows*cols*(2r)^2, 13 | 14] f32.
extern "C" int kde_nasp_cell_sums(const int* labels, const float* color,
                                  const float* points, const float* normals,
                                  const float* cand, float* out, int B, int H, int W,
                                  int rows, int cols, int r, float lo, float hi, int mode,
                                  float c2, float s2, void* stream) {
  Cells c;
  if (B <= 0 || (mode != 0 && mode != 1) || !make_cells(H, W, rows, cols, r, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  NaspSumsLoader ld{labels, color, points, normals, cand, c, lo, hi, c2, s2, mode};
  nasp_sums_kernel<<<dim3(cols, rows, B), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      ld, out);
  return launched();
}

// color, points, normals [B, H, W, 3] f32; cand [B, rows, cols, 9] f32 (rgb,
// x, y, center z, normal); labels [B, H, W] i32, dist [B, H, W] f32 and
// out [B, rows*cols*(2r)^2, 13] f32 are written.  w_* are the distance
// weights and s2scale = s_scale^2, each as the plain version rounds them.
extern "C" int kde_nasp_assign_analyze(const float* color, const float* points,
                                       const float* normals, const float* cand,
                                       int* labels, float* dist, float* out, int B, int H,
                                       int W, int rows, int cols, int r, float lo, float hi,
                                       float w_col, float w_spa, float w_dep, float w_nor,
                                       float s2scale, int apply_invalid, void* stream) {
  Cells c;
  if (B <= 0 || r > 4 || !make_cells(H, W, rows, cols, r, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  AssignLoader ld{color, points, normals, labels, dist, nullptr, nullptr, c, lo, hi,
                  w_col, w_spa, w_dep, w_nor, s2scale, apply_invalid};
  assign_analyze_kernel<<<dim3(cols, rows, B), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      ld, cand, out);
  return launched();
}
