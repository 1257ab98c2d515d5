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
// NASP update sums and the fused assignment (cell_sums): one 256-thread
// block per (frame, cell).  The cell's pixels are staged in chunks of 256 in
// shared memory (candidate slot + F features each); thread t owns outputs
// (slot, feature) o = t + 256k and walks the chunk in pixel order, adding
// matching features into a double: O(P * n * F) compares per cell.  The
// assignment keeps the plain version's operation order (built with
// -fmad=false, IEEE sqrtf and division) and candidates dy-major with a
// strict <, so labels and distances are bitwise equal to it.  The weighted
// features flush subnormal weights to 0 as XLA does (stencil.flush_subnormal
// in the plain version).
//
// Label-cell sums (label_sums_kernel): one 256-thread block per (frame,
// cell), O(P * F) work.  Warp w takes a fixed run of the cell's pixels in
// row order, 32 a round, with three rounds in flight to shared memory by
// cp.async (labels, and features 16 or 8 bytes a copy where F and the
// pointer allow); a pixel's slot comes from a per-block table over the
// candidate rows, with no division per pixel.  Each lane keeps a double
// run sum of its own pixels while their slot stays the same and flushes it
// when the slot changes (and after the last round).  A flush groups the
// flushing lanes by slot (__match_any_sync) and sums each group by a fixed
// shuffle tree, non-members adding 0, into the warp's double partial row in
// shared memory.  After one barrier thread t owns outputs t + 256k and adds
// the 8 warps' partials in warp order.  The order of every sum is fixed by
// the labels alone.  At 640x480 the 300 blocks are one wave; the bound is
// the 3.7 MB read, ~1.1 us; what sets the time is each warp's chain of
// dependent rounds and its flush trees, more of them where a cell's labels
// change often.  Shared memory grows with n * F (~25 KB at r = 4, F = 2;
// ~205 KB at r = 5, F = 16, opted in above 48 KB).
//
// Label-cell gather (label_gather_kernel): one block per (frame, image
// row), so the cell row is the block's.  It stages the table rows its
// candidates can name (2r cell rows x cols x F floats) and each label's
// pixel window, resolves the row's W labels to table offsets once, then
// writes the row's W * F floats contiguously, 16 bytes a thread where W * F
// and the pointer allow; F is a template parameter for 1, 3 and 6.  Bound:
// the output, 7.4 MB at F = 6, B = 1, ~2.2 us.
//
// No atomics of any kind: each sum has one owner and an order fixed by the
// inputs, so runs are bitwise repeatable, and a double sum of f32 terms is
// exact for integer-valued features (counts, colours, u, v) and within 1
// ulp of the exact sum for the rest.  The gather only copies.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int CH = 256;        // pixels staged per chunk
constexpr int KO = 4;          // outputs a thread owns per pass
constexpr int MAXF = 16;       // most features a sums kernel stages per pixel
constexpr int MAXN = 64;       // most candidates of the fused assignment (r <= 4)
constexpr size_t MAX_SMEM = 232448;  // shared memory a block may opt in to (sm_90)
constexpr int NS = 4;          // rounds a label-sums warp keeps in flight
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

// The table rows that the candidates of cell row cy can name: cell rows
// [ly0, ly1) of the grid, labels [ly0 * cols, ly1 * cols).
__device__ __forceinline__ void cand_rows(const Cells& c, int cy, int* ly0, int* ly1) {
  *ly0 = max(cy - c.r, 0);
  *ly1 = min(cy + c.r, c.rows);
}

// Most candidate labels of one cell row: 2r cell rows of the grid.
size_t max_rel(const Cells& c) {
  return static_cast<size_t>(std::min(2 * c.r, c.rows)) * c.cols;
}

// Dynamic shared memory of label_sums_kernel: the warps' double partials
// [NW][n*F], the threads' open run sums [F][NT] (read when F > 4), the
// warps' NS staging buffers of 32 pixels' features [NW][NS][32*F] and
// labels [NW][NS][32], and the slot table.
size_t label_sums_smem(const Cells& c, int F) {
  const size_t n = 4 * static_cast<size_t>(c.r) * c.r;
  return sizeof(double) * (NW * n + NT) * F + sizeof(float) * NW * NS * 32 * F +
         sizeof(int) * NW * NS * 32 + sizeof(int) * max_rel(c);
}

// Per-(cell, candidate) sums of pre-masked features, one block per
// (frame, cell).  Warp w walks a fixed run of the cell's pixels, 32 a round
// in row order, with the next NS - 1 rounds in flight to shared memory
// (cp.async, 4 * VEC bytes a copy).  Each lane sums its own pixels down the
// rounds while their slot stays the same (in registers when REG, F <= FC;
// else in shared memory) and flushes the run when its slot changes; all
// lanes flush after the last round.  A flush sums each slot's runs by a
// fixed shuffle tree over the warp (lanes not in the group add 0), FC
// features' trees interleaved, into the warp's partial row, groups in
// ascending order of their first lane.
template <int VEC, int FC, bool REG>
__global__ void __launch_bounds__(NT)
label_sums_kernel(const int* __restrict__ labels, const float* __restrict__ feats,
                  float* __restrict__ out, Cells c, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr unsigned ALL = 0xffffffffu;
  const int n = 4 * c.r * c.r, nF = n * F;
  const int b = blockIdx.z, cy = blockIdx.y, cx = blockIdx.x;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  int ly0, ly1;
  cand_rows(c, cy, &ly0, &ly1);
  const int base = ly0 * c.cols, nrel = (ly1 - ly0) * c.cols;
  double* part = reinterpret_cast<double*>(smem);                 // [NW][n*F]
  double* accs = part + NW * nF;                                   // [F][NT]
  float* stage = reinterpret_cast<float*>(accs + NT * F);          // [NW][NS][32*F]
  int* s_lab = reinterpret_cast<int*>(stage + NW * NS * 32 * F);   // [NW][NS][32]
  int* s_slot = s_lab + NW * NS * 32;                              // [nrel]
  for (int i = tid; i < NW * nF; i += NT) part[i] = 0.0;
  // candidate slot of label base + rel in this cell, -1 if none
  for (int rel = tid; rel < nrel; rel += NT) {
    const int dy = ly0 + rel / c.cols - cy, dx = rel % c.cols - cx;
    s_slot[rel] = (dx >= -c.r && dx < c.r) ? (dy + c.r) * 2 * c.r + (dx + c.r) : -1;
  }

  // warp w: pixels [p0, p1) of the cell; the lane's pixel (py, px) in the
  // cell advances by 32 a round without division
  const int P = c.bs_y * c.bs_x;
  const int per = (P + NT - 1) / NT * 32;
  const int p0 = w * per, p1 = min(p0 + per, P);
  const int rounds = p1 > p0 ? (p1 - p0 + 31) / 32 : 0;
  int py = (p0 + lane) / c.bs_x, px = p0 + lane - py * c.bs_x;
  const int step_y = 32 / c.bs_x, step_x = 32 - step_y * c.bs_x;
  const float* fimg = feats + static_cast<size_t>(b) * c.H * c.W * F;
  const int* limg = labels + static_cast<size_t>(b) * c.H * c.W;
  const int y0 = cy * c.bs_y, x0 = cx * c.bs_x;
  double* wpart = part + w * nF;
  float* wstage = stage + w * NS * 32 * F;
  int* wlab = s_lab + w * NS * 32;
  // copy round k's label and features of this lane into buffer k % NS;
  // every call commits one group, empty past the last round
  auto fetch = [&](int k) {
    if (k < rounds) {
      if (p0 + 32 * k + lane < p1) {
        const size_t pix = static_cast<size_t>(y0 + py) * c.W + (x0 + px);
        const int buf = k % NS;
        __pipeline_memcpy_async(wlab + buf * 32 + lane, limg + pix, sizeof(int));
        float* dst = wstage + (buf * 32 + lane) * F;
        const float* src = fimg + pix * F;
        for (int i = 0; i < F; i += VEC) {
          __pipeline_memcpy_async(dst + i, src + i, sizeof(float) * VEC);
        }
      }
      px += step_x;
      py += step_y;
      if (px >= c.bs_x) {
        px -= c.bs_x;
        ++py;
      }
    }
    __pipeline_commit();
  };
  for (int k = 0; k < NS - 1; ++k) fetch(k);

  // the lane's open run: its slot (-1: none) and sums
  int cur = -1;
  double racc[FC];
#pragma unroll
  for (int j = 0; j < FC; ++j) racc[j] = 0.0;
  double* sacc = accs + tid;  // sacc[f * NT]
  if constexpr (!REG) {
    for (int f = 0; f < F; ++f) sacc[f * NT] = 0.0;
  }
  __syncthreads();

  // flush the runs of the lanes where `out`; they open empty runs
  auto flush = [&](bool out) {
    const int key = out ? cur : -1;
    const unsigned peers = __match_any_sync(ALL, key);
    unsigned todo = __ballot_sync(ALL, key >= 0 && lane == __ffs(static_cast<int>(peers)) - 1);
    while (todo != 0u) {
      const int first = __ffs(static_cast<int>(todo)) - 1;
      todo &= todo - 1u;
      const bool mine = (__shfl_sync(ALL, peers, first) >> lane) & 1u;
      const int gslot = __shfl_sync(ALL, key, first);
      for (int f0 = 0; f0 < F; f0 += FC) {
        double v[FC];
#pragma unroll
        for (int j = 0; j < FC; ++j) {
          double a = 0.0;
          if constexpr (REG) {
            a = racc[j];
          } else if (f0 + j < F) {
            a = sacc[(f0 + j) * NT];
          }
          v[j] = mine ? a : 0.0;
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
          for (int j = 0; j < FC; ++j) v[j] += __shfl_down_sync(ALL, v[j], s);
        }
        if (lane == 0) {
#pragma unroll
          for (int j = 0; j < FC; ++j) {
            if (f0 + j < F) wpart[gslot * F + f0 + j] += v[j];
          }
        }
      }
    }
    if (out) {
#pragma unroll
      for (int j = 0; j < FC; ++j) racc[j] = 0.0;
      if constexpr (!REG) {
        for (int f = 0; f < F; ++f) sacc[f * NT] = 0.0;
      }
    }
  };

  for (int k = 0; k < rounds; ++k) {
    fetch(k + NS - 1);
    __pipeline_wait_prior(NS - 1);  // round k has landed
    __syncwarp();
    const int buf = k % NS;
    int slot = -1;
    if (p0 + 32 * k + lane < p1) {
      const int rel = wlab[buf * 32 + lane] - base;
      if (rel >= 0 && rel < nrel) slot = s_slot[rel];
    }
    const bool change = slot >= 0 && cur >= 0 && slot != cur;
    if (__any_sync(ALL, change)) flush(change);
    if (slot >= 0) {
      cur = slot;
      const float* fl = wstage + (buf * 32 + lane) * F;
      if constexpr (REG) {
#pragma unroll
        for (int j = 0; j < FC; ++j) {
          if (j < F) racc[j] += static_cast<double>(fl[j]);
        }
      } else {
        for (int f = 0; f < F; ++f) sacc[f * NT] += static_cast<double>(fl[f]);
      }
    }
    __syncwarp();
  }
  if (__any_sync(ALL, cur >= 0)) flush(cur >= 0);
  __syncthreads();

  // one owner per output: the warps' partials in warp order
  float* ob = out + (static_cast<size_t>(b * c.rows + cy) * c.cols + cx) * nF;
  for (int o = tid; o < nF; o += NT) {
    double a = 0.0;
#pragma unroll
    for (int k = 0; k < NW; ++k) a += part[k * nF + o];
    ob[o] = static_cast<float>(a);
  }
}

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

// Dynamic shared memory of label_gather_kernel: each candidate label's
// pixel window [x_lo, x_hi), its F table floats, and the row's F-float
// offsets into them.
size_t label_gather_smem(const Cells& c, int F) {
  return (sizeof(int2) + sizeof(float) * F) * max_rel(c) + sizeof(int) * c.W;
}

// table[label] for one image row per block: y, and so the cell row, is
// the block's; F = FT when FT > 0, else F_rt.  VEC4: 16-byte stores.
template <int FT, bool VEC4>
__global__ void __launch_bounds__(NT)
label_gather_kernel(const int* __restrict__ labels, const float* __restrict__ table,
                    float* __restrict__ out, Cells c, int F_rt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = FT > 0 ? FT : F_rt;
  const int y = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  int ly0, ly1;
  cand_rows(c, y / c.bs_y, &ly0, &ly1);
  const int base = ly0 * c.cols, nrel = (ly1 - ly0) * c.cols;
  int2* s_win = reinterpret_cast<int2*>(smem);                  // [nrel]
  float* s_tab = reinterpret_cast<float*>(s_win + nrel);        // [nrel][F]
  int* s_off = reinterpret_cast<int*>(s_tab + nrel * F);        // [W]
  // the staged rows are contiguous in the table
  const float* src = table + (static_cast<size_t>(b) * c.rows * c.cols + base) * F;
  for (int i = tid; i < nrel * F; i += NT) s_tab[i] = src[i];
  // label base + rel (cell column lx) is a candidate of the pixels whose
  // cell column lies in (lx - r, lx + r]
  for (int rel = tid; rel < nrel; rel += NT) {
    const int lx = rel % c.cols;
    s_win[rel] = make_int2((lx - c.r + 1) * c.bs_x, (lx + c.r + 1) * c.bs_x);
  }
  __syncthreads();
  const size_t row = (static_cast<size_t>(b) * c.H + y) * c.W;
  for (int x = tid; x < c.W; x += NT) {
    const int rel = labels[row + x] - base;
    int off = -1;
    if (rel >= 0 && rel < nrel) {
      const int2 win = s_win[rel];
      if (x >= win.x && x < win.y) off = rel * F;
    }
    s_off[x] = off;
  }
  __syncthreads();
  // the row's W*F output floats, contiguous across the block
  float* orow = out + row * F;
  const int total = c.W * F;
  if constexpr (VEC4) {
    for (int e = 4 * tid; e < total; e += 4 * NT) {
      int x = e / F, f = e - x * F;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int off = s_off[x];
        v[k] = off >= 0 ? s_tab[off + f] : 0.0f;
        if (++f == F) {
          f = 0;
          ++x;
        }
      }
      *reinterpret_cast<float4*>(orow + e) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int e = tid; e < total; e += NT) {
      const int x = e / F, f = e - x * F;
      const int off = s_off[x];
      orow[e] = off >= 0 ? s_tab[off + f] : 0.0f;
    }
  }
}

bool make_cells(int H, int W, int rows, int cols, int r, Cells* c) {
  if (H <= 0 || W <= 0 || rows <= 0 || cols <= 0 || r < 1) return false;
  if (H % rows != 0 || W % cols != 0) return false;
  *c = Cells{H, W, rows, cols, r, H / rows, W / cols};
  return true;
}

int launched() { return static_cast<int>(cudaGetLastError()); }

// Launch `kernel` with `smem` bytes of dynamic shared memory, opting in
// above the default 48 KB.
template <class Kernel, class... Args>
int launch_dyn(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return launched();
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// labels [B, H, W] i32; table [B, rows*cols, F] f32; out [B, H, W, F] f32.
extern "C" int kde_label_cell_gather(const int* labels, const float* table, float* out,
                                     int B, int H, int W, int rows, int cols, int r, int F,
                                     void* stream) {
  Cells c;
  if (B <= 0 || F <= 0 || B > 65535 || !make_cells(H, W, rows, cols, r, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, B);
  const size_t smem = label_gather_smem(c, F);
  const bool vec4 = (W * F) % 4 == 0 && aligned(out, 16);
  const auto as = [&](auto kernel) {
    return launch_dyn(kernel, grid, smem, stream, labels, table, out, c, F);
  };
  switch (F) {
    case 1: return vec4 ? as(label_gather_kernel<1, true>) : as(label_gather_kernel<1, false>);
    case 3: return vec4 ? as(label_gather_kernel<3, true>) : as(label_gather_kernel<3, false>);
    case 6: return vec4 ? as(label_gather_kernel<6, true>) : as(label_gather_kernel<6, false>);
    default: return vec4 ? as(label_gather_kernel<0, true>) : as(label_gather_kernel<0, false>);
  }
}

// labels [B, H, W] i32; feats [B, H, W, F] f32 (pre-masked);
// out [B, rows*cols*(2r)^2, F] f32.
extern "C" int kde_label_cell_sums(const int* labels, const float* feats, float* out,
                                   int B, int H, int W, int rows, int cols, int r, int F,
                                   void* stream) {
  Cells c;
  if (B <= 0 || F <= 0 || F > MAXF || B > 65535 || rows > 65535 ||
      !make_cells(H, W, rows, cols, r, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cols, rows, B);
  const size_t smem = label_sums_smem(c, F);
  const int vec = F % 4 == 0 && aligned(feats, 16) ? 4 : F % 2 == 0 && aligned(feats, 8) ? 2 : 1;
  const auto as = [&](auto kernel) {
    return launch_dyn(kernel, grid, smem, stream, labels, feats, out, c, F);
  };
  if (F == 1) return as(label_sums_kernel<1, 1, true>);
  if (F == 2) {
    return vec == 2 ? as(label_sums_kernel<2, 2, true>) : as(label_sums_kernel<1, 2, true>);
  }
  if (F <= 4) {
    return vec == 4   ? as(label_sums_kernel<4, 4, true>)
           : vec == 2 ? as(label_sums_kernel<2, 4, true>)
                      : as(label_sums_kernel<1, 4, true>);
  }
  return vec == 4   ? as(label_sums_kernel<4, 4, false>)
         : vec == 2 ? as(label_sums_kernel<2, 4, false>)
                    : as(label_sums_kernel<1, 4, false>);
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
