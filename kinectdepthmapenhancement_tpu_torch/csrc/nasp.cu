// NASP cell kernels: label-cell gather, and three per-(cell, candidate)
// sums kernels on one reduction: label-cell sums, NASP update sums and the
// fused first assignment + analyze sums.
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
// lane maps become one index, read from a per-block table over the
// candidate rows (no division per pixel).
//
// The sums (run_sums): one 256-thread block per (frame, cell), O(P * F)
// work.  Warp w takes a fixed run of the cell's pixels, 32 a round in row
// order, and a per-kernel source gives each lane its round's pixel: its
// candidate slot (-1: it adds nothing) and its F features.  The label-cell
// sums stage labels and pre-masked features by cp.async, three rounds
// ahead; the NASP update sums read label, colour, point and normal and form
// the features in registers (nasp_features).  Each lane keeps a double run
// sum of its pixels in registers while their slot stays the same and
// flushes it when the slot changes, all lanes after the last round.  A
// flush groups the flushing lanes by slot (__match_any_sync) and sums every
// group at once by a tree over the members' ranks in their group, one
// shuffle a feature and level for the whole warp; the group's first lane
// adds the sum into the warp's double partial row in shared memory.  After
// one barrier thread t owns outputs t + 256k and adds the 8 warps' partials
// in warp order.  Bound: the bytes, one read of the planes (3.7 MB for the
// label sums at 640x480, ~13 MB for the NASP sums), 1-4 us; what sets the
// time is each warp's chain of dependent rounds, the flush trees (more of
// them where a cell's labels change often) and the block's prologue and
// epilogue over its partials, NW * n * F doubles: 57,344 B at r = 4, F =
// 14, so three blocks an SM and all 300 blocks of a 640x480 frame resident
// at once (__launch_bounds__(NT, 3) holds the registers to that).
//
// The fused kernel runs the first assignment (calculateLD_NASP) of the
// block's pixels, then run_sums over the analyze features of the labels it
// gave.  Bound: the issue of the candidate sweep, ~60 instructions per
// pixel and in-grid candidate in the plain version's operation order
// (built with -fmad=false, IEEE sqrtf and division; candidates dy-major, a
// strict <), which keeps labels and distances bitwise equal to it; the
// operation bound of the same 0.5 GFLOP is ~7x lower.  The in-grid
// candidates are staged once per cell as three 16-byte rows each
// (broadcast loads), their depth and normal validity formed there; only
// the first out-of-grid candidate can win (it costs INIT_DISTANCE), so it
// is compared once.  The loop holds the table's shared address and the
// pixel's u, v in registers (the compiler would recompute them each
// candidate under the three-blocks-an-SM register cap).
//
// The weighted features flush subnormal weights to 0 as XLA does
// (stencil.flush_subnormal in the plain version).
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
// labels alone, so runs are bitwise repeatable, and a double sum of f32
// terms is exact for integer-valued features (counts, colours, u, v) and
// within 1 ulp of the exact sum for the rest.  The gather only copies.
// Dynamic shared memory above 48 KB is allowed once per kernel and device
// (no kernel here has static shared memory).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int MAXF = 16;       // most features of a label-cell sums call
constexpr size_t MAX_SMEM = 232448;  // shared memory a block may opt in to (sm_90)
constexpr int NS = 4;          // rounds a label-sums warp keeps in flight
constexpr int N_ANALYZE = 13;
constexpr int N_WEIGHTED = 14;
constexpr float VALID_DEPTH_MM = 50.0f;
constexpr float INVALID_NORMAL = -1.0f;
constexpr float INIT_DISTANCE = 999999.9f;  // the JAX package's slic.INIT_DISTANCE in f32
constexpr unsigned ALL = 0xffffffffu;

struct Cells {
  int H, W, rows, cols, r, bs_y, bs_x;
};

__device__ __forceinline__ float flush(float x) { return x < FLT_MIN ? 0.0f : x; }

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

// The candidate slot of a label in the block's cell (-1: none), from a
// shared table over the labels [base, base + nrel) of its candidate rows.
struct SlotTable {
  int base, nrel;
  const int* slot;
  __device__ int operator()(int label) const {
    const int rel = label - base;
    return rel >= 0 && rel < nrel ? slot[rel] : -1;
  }
};

// Fill the slot table of cell (cy, cx) into s_slot (max_rel entries); read
// it after a barrier.
__device__ SlotTable slot_table(const Cells& c, int cy, int cx, int* s_slot) {
  int ly0, ly1;
  cand_rows(c, cy, &ly0, &ly1);
  const int nrel = (ly1 - ly0) * c.cols;
  for (int rel = threadIdx.x; rel < nrel; rel += NT) {
    const int dy = ly0 + rel / c.cols - cy, dx = rel % c.cols - cx;
    s_slot[rel] = (dx >= -c.r && dx < c.r) ? (dy + c.r) * 2 * c.r + (dx + c.r) : -1;
  }
  return {ly0 * c.cols, nrel, s_slot};
}

// Warp w's pixels of the cell: [p0, p1), lane l at p0 + 32k + l in round k.
struct Walk {
  int p0, p1, rounds;
  __device__ Walk(const Cells& c, int w) {
    const int P = c.bs_y * c.bs_x;
    const int per = (P + NT - 1) / NT * 32;
    p0 = w * per;
    p1 = min(p0 + per, P);
    rounds = p1 > p0 ? (p1 - p0 + 31) / 32 : 0;
  }
  __device__ bool live(int k, int lane) const { return p0 + 32 * k + lane < p1; }
};

// A lane's pixel (py, px) in its cell, advanced by 32 pixels a step
// without division.
struct Cursor {
  int py, px, sy, sx, bs_x;
  __device__ Cursor(const Cells& c, int p) : bs_x(c.bs_x) {
    py = p / bs_x;
    px = p - py * bs_x;
    sy = 32 / bs_x;
    sx = 32 - sy * bs_x;
  }
  __device__ void next() {
    px += sx;
    py += sy;
    if (px >= bs_x) {
      px -= bs_x;
      ++py;
    }
  }
};

__device__ __forceinline__ void zero_partials(double* part, int count) {
  for (int i = threadIdx.x; i < count; i += NT) part[i] = 0.0;
}

// The block's cell's [n * F] rows of the [B, rows*cols*n, F] partial table.
__device__ __forceinline__ float* cell_out(float* out, const Cells& c, int nF) {
  const size_t cell = (static_cast<size_t>(blockIdx.z) * c.rows + blockIdx.y) * c.cols + blockIdx.x;
  return out + cell * nF;
}

// Per-(cell, candidate) sums of F <= FC features for the block's cell, the
// one reduction of every sums kernel here.  `src.load(k, live, f)` gives
// the lane's round-k pixel (`live`: the pixel exists): its candidate slot
// (-1: it adds nothing) and its features f.  Each lane sums its pixels
// while their slot stays the same and flushes the run when the slot
// changes; all lanes flush after the last round.  part: the warps' partial
// rows [NW][n * F], zeroed before the barrier that precedes this call.
template <int FC, class Source>
__device__ void run_sums(Source& src, const Walk& walk, int F, int nF, double* part,
                         float* ob) {
  const int lane = threadIdx.x & 31;
  double* wpart = part + (threadIdx.x >> 5) * nF;
  int cur = -1;  // the lane's open run: its slot (-1: none) and sums
  double racc[FC];
#pragma unroll
  for (int j = 0; j < FC; ++j) racc[j] = 0.0;

  // flush the runs of the lanes where `out`, every slot's group at once:
  // at level s, the member of rank i (i % 2s == 0) adds the partial of rank
  // i + s; `nxt` is that member's lane (-1: none), found by pointer jumping
  auto flush_runs = [&](bool out) {
    const unsigned peers = __match_any_sync(ALL, out ? cur : -1);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const int most = static_cast<int>(__reduce_max_sync(ALL, out ? __popc(peers) : 0));
    const unsigned later = lane == 31 ? 0u : peers & (ALL << (lane + 1));
    int nxt = later ? __ffs(static_cast<int>(later)) - 1 : -1;
    for (int s = 1; s < most; s <<= 1) {
      const int from = nxt >= 0 ? nxt : lane;
      const bool take = out && nxt >= 0 && (rank & (2 * s - 1)) == 0;
#pragma unroll
      for (int j = 0; j < FC; ++j) {
        const double v = __shfl_sync(ALL, racc[j], from);
        if (take) racc[j] += v;
      }
      nxt = __shfl_sync(ALL, nxt, from);
    }
    if (out) {
      if (rank == 0) {
#pragma unroll
        for (int j = 0; j < FC; ++j) {
          if (j < F) wpart[cur * F + j] += racc[j];
        }
      }
#pragma unroll
      for (int j = 0; j < FC; ++j) racc[j] = 0.0;
    }
  };

  for (int k = 0; k < walk.rounds; ++k) {
    float f[FC];
    const int slot = src.load(k, walk.live(k, lane), f);
    const bool change = slot >= 0 && cur >= 0 && slot != cur;
    if (__any_sync(ALL, change)) flush_runs(change);
    if (slot >= 0) {
      cur = slot;
#pragma unroll
      for (int j = 0; j < FC; ++j) {
        if (j < F) racc[j] += static_cast<double>(f[j]);
      }
    }
  }
  if (__any_sync(ALL, cur >= 0)) flush_runs(cur >= 0);
  __syncthreads();

  // one owner per output: the warps' partials in warp order
  for (int o = threadIdx.x; o < nF; o += NT) {
    double a = 0.0;
#pragma unroll
    for (int k = 0; k < NW; ++k) a += part[k * nF + o];
    ob[o] = static_cast<float>(a);
  }
}

// Label-cell sums' source: the lane's labels and pre-masked features,
// staged by cp.async NS - 1 rounds ahead into the warp's NS buffers (4 * VEC
// bytes a copy).
template <int VEC, int FC>
struct StagedSource {
  const int* labels;    // the frame's [H, W]
  const float* feats;   // the frame's [H, W, F]
  int* wlab;            // [NS][32]
  float* wstage;        // [NS][32 * F]
  SlotTable slots;
  Walk walk;
  Cursor at;            // the pixel of the next fetch
  int F, W, x0, y0, lane;

  // copy round k's label and features into buffer k % NS; every call
  // commits one group, empty past the last round
  __device__ void fetch(int k) {
    if (k < walk.rounds) {
      if (walk.live(k, lane)) {
        const size_t pix = static_cast<size_t>(y0 + at.py) * W + (x0 + at.px);
        const int buf = k % NS;
        __pipeline_memcpy_async(wlab + buf * 32 + lane, labels + pix, sizeof(int));
        float* dst = wstage + (buf * 32 + lane) * F;
        const float* src = feats + pix * F;
        for (int i = 0; i < F; i += VEC) {
          __pipeline_memcpy_async(dst + i, src + i, sizeof(float) * VEC);
        }
      }
      at.next();
    }
    __pipeline_commit();
  }

  __device__ int load(int k, bool live, float (&f)[FC]) {
    fetch(k + NS - 1);
    __pipeline_wait_prior(NS - 1);  // round k has landed
    __syncwarp();
    const int buf = k % NS;
    const int slot = live ? slots(wlab[buf * 32 + lane]) : -1;
    if (slot >= 0) {
      const float* fl = wstage + (buf * 32 + lane) * F;
#pragma unroll
      for (int j = 0; j < FC; ++j) f[j] = j < F ? fl[j] : 0.0f;
    }
    __syncwarp();  // buffer k % NS is refilled by the next round's fetch
    return slot;
  }
};

// Dynamic shared memory of label_sums_kernel: the warps' double partials
// [NW][n*F], the warps' NS staging buffers of 32 pixels' features
// [NW][NS][32*F] and labels [NW][NS][32], and the slot table.
size_t label_sums_smem(const Cells& c, int F) {
  const size_t n = 4 * static_cast<size_t>(c.r) * c.r;
  return sizeof(double) * NW * n * F + sizeof(float) * NW * NS * 32 * F +
         sizeof(int) * NW * NS * 32 + sizeof(int) * max_rel(c);
}

// Per-(cell, candidate) sums of F <= FC pre-masked features, one block per
// (frame, cell).
template <int VEC, int FC>
__global__ void __launch_bounds__(NT)
label_sums_kernel(const int* __restrict__ labels, const float* __restrict__ feats,
                  float* __restrict__ out, Cells c, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nF = 4 * c.r * c.r * F;
  const int b = blockIdx.z, cy = blockIdx.y, cx = blockIdx.x;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double* part = reinterpret_cast<double*>(smem);                  // [NW][n*F]
  float* stage = reinterpret_cast<float*>(part + NW * nF);         // [NW][NS][32*F]
  int* s_lab = reinterpret_cast<int*>(stage + NW * NS * 32 * F);   // [NW][NS][32]
  int* s_slot = s_lab + NW * NS * 32;                              // [max_rel]
  zero_partials(part, NW * nF);
  const size_t frame = static_cast<size_t>(b) * c.H * c.W;
  const Walk walk(c, w);
  StagedSource<VEC, FC> src{labels + frame, feats + frame * F, s_lab + w * NS * 32,
                            stage + w * NS * 32 * F, slot_table(c, cy, cx, s_slot), walk,
                            Cursor(c, walk.p0 + lane), F, c.W, cx * c.bs_x, cy * c.bs_y,
                            lane};
  for (int k = 0; k < NS - 1; ++k) src.fetch(k);
  __syncthreads();
  run_sums<FC>(src, walk, F, nF, part, cell_out(out, c, nF));
}

// A pixel's slot from its label (the NASP update sums).
struct LabelSlot {
  const int* labels;  // the frame's [H, W]
  SlotTable slots;
  __device__ int operator()(size_t pix, int) const { return slots(labels[pix]); }
};

// A pixel's slot as the fused kernel's assignment left it, by pixel of the
// cell.
struct AssignedSlot {
  const int* slot;  // [P]
  __device__ int operator()(size_t, int p) const { return slot[p]; }
};

// NASP update sums' source: the lane's slot (SlotOf), colour, point and
// normal read directly (coalesced across the warp), its features formed in
// registers from its cluster's fields, staged per candidate slot
// (fld[j * NFLD]).
template <bool WEIGHTED, class SlotOf>
struct NaspSource {
  static constexpr int F = WEIGHTED ? N_WEIGHTED : N_ANALYZE;
  static constexpr int NFLD = WEIGHTED ? 8 : 2;  // x, y (, rgb 3, normal 3)
  SlotOf slot_of;
  const float *color, *points, *normals;  // the frame's [H, W, 3]
  const float* fld;                       // [n][NFLD]
  Cursor at;
  int W, x0, y0;
  float lo, hi, c2, s2;

  __device__ int load(int, bool live, float (&f)[F]) {
    int slot = -1;
    if (live) {
      const int x = x0 + at.px, y = y0 + at.py;
      const size_t pix = static_cast<size_t>(y) * W + x;
      slot = slot_of(pix, at.py * at.bs_x + at.px);
      const float col[3] = {color[3 * pix], color[3 * pix + 1], color[3 * pix + 2]};
      const float pt[3] = {points[3 * pix], points[3 * pix + 1], points[3 * pix + 2]};
      const float nm[3] = {normals[3 * pix], normals[3 * pix + 1], normals[3 * pix + 2]};
      if (slot >= 0 && !nasp_features(WEIGHTED, static_cast<float>(x), static_cast<float>(y),
                                       col, pt, nm, fld + slot * NFLD, lo, hi, c2, s2, f)) {
        slot = -1;
      }
    }
    at.next();
    return slot;
  }
};

// Dynamic shared memory of nasp_sums_kernel: the warps' double partials
// [NW][n*F], the candidates' fields [n][NFLD] and the slot table.
size_t nasp_sums_smem(const Cells& c, bool weighted) {
  const size_t n = 4 * static_cast<size_t>(c.r) * c.r;
  const size_t F = weighted ? N_WEIGHTED : N_ANALYZE, nfld = weighted ? 8 : 2;
  return sizeof(double) * NW * n * F + sizeof(float) * n * nfld + sizeof(int) * max_rel(c);
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(NT, 3)
nasp_sums_kernel(const int* __restrict__ labels, const float* __restrict__ color,
                 const float* __restrict__ points, const float* __restrict__ normals,
                 const float* __restrict__ cand, float* __restrict__ out, Cells c,
                 float lo, float hi, float c2, float s2) {
  using Src = NaspSource<WEIGHTED, LabelSlot>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 4 * c.r * c.r, nF = n * Src::F;
  const int b = blockIdx.z, cy = blockIdx.y, cx = blockIdx.x;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double* part = reinterpret_cast<double*>(smem);             // [NW][n*F]
  float* fld = reinterpret_cast<float*>(part + NW * nF);      // [n][NFLD]
  int* s_slot = reinterpret_cast<int*>(fld + n * Src::NFLD);  // [max_rel]
  zero_partials(part, NW * nF);
  // the fields of each in-grid candidate (cand: [B, rows*cols, NFLD])
  const int two_r = 2 * c.r;
  for (int i = threadIdx.x; i < n * Src::NFLD; i += NT) {
    const int j = i / Src::NFLD;
    const int ny = cy + j / two_r - c.r, nx = cx + j % two_r - c.r;
    const bool ing = ny >= 0 && ny < c.rows && nx >= 0 && nx < c.cols;
    const size_t row = static_cast<size_t>(b) * c.rows * c.cols + ny * c.cols + nx;
    fld[i] = ing ? cand[row * Src::NFLD + i % Src::NFLD] : 0.0f;
  }
  const size_t frame = static_cast<size_t>(b) * c.H * c.W;
  const Walk walk(c, w);
  Src src{{labels + frame, slot_table(c, cy, cx, s_slot)}, color + 3 * frame,
          points + 3 * frame, normals + 3 * frame, fld, Cursor(c, walk.p0 + lane), c.W,
          cx * c.bs_x, cy * c.bs_y, lo, hi, c2, s2};
  __syncthreads();
  run_sums<Src::F>(src, walk, Src::F, nF, part, cell_out(out, c, nF));
}

constexpr int OUT_OF_GRID = -2;  // the winner is an out-of-grid candidate

// A 16-byte load from shared memory at a 32-bit shared-window address.
__device__ __forceinline__ float4 ld_shared4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(addr));
  return v;
}

// The first NASP assignment (calculateLD_NASP, the plain version's
// band-space sweep) of one pixel over the cell's candidates.  The in-grid
// candidates are the offsets [dy0, dy1) x [dx0, dx1), staged dy-major as m
// 16-byte rows of three: float4 (r, g, b, x), float4 (y, center z, n0, n1)
// and int4 (n2 bits, id, slot, flags: 1 center z valid, 2 also its normal
// valid).  An out-of-grid candidate costs INIT_DISTANCE and names the
// pixel's own cell; with a strict < only the first one (dy-major) can win,
// so it is compared once, after the first m0 in-grid candidates.  Writes
// the pixel's label and distance, and its slot (-1 for none) to s_slot[p]
// for the analyze sums.
struct Assigner {
  const float *color, *points, *normals;  // the frame's [H, W, 3]
  int* labels;                            // the frame's [H, W], written
  float* dist;                            // the frame's [H, W], written
  const float4* cand;                     // [m][3]
  int* s_slot;                            // [P], written
  int m, m0, out_of_grid, own, own_slot, W, x0, y0, apply_invalid;
  float w_col, w_spa, w_dep, w_nor, s2scale;

  __device__ void pixel(int px, int py, int p) const {
    const int x = x0 + px, y = y0 + py;
    const size_t pix = static_cast<size_t>(y) * W + x;
    const float col[3] = {color[3 * pix], color[3 * pix + 1], color[3 * pix + 2]};
    const float zc = points[3 * pix + 2];
    const float nm[3] = {normals[3 * pix], normals[3 * pix + 1], normals[3 * pix + 2]};
    float u = static_cast<float>(x), v = static_cast<float>(y);
    // u, v and the table's shared address are held in registers, not
    // recomputed for every candidate
    unsigned tab = static_cast<unsigned>(__cvta_generic_to_shared(cand));
    asm("" : "+f"(u), "+f"(v), "+r"(tab));
    const bool z_valid = zc > VALID_DEPTH_MM;
    const bool zn_valid = z_valid && normal_valid(nm);
    float bd = INFINITY;
    int best = -1;  // the winner's row, OUT_OF_GRID or none
    const auto consider = [&](int i) {
      const float4 ca = ld_shared4(tab + 48 * i), cb = ld_shared4(tab + 48 * i + 16);
      const float4 cf = ld_shared4(tab + 48 * i + 32);
      const int4 cc = make_int4(__float_as_int(cf.x), __float_as_int(cf.y),
                                __float_as_int(cf.z), __float_as_int(cf.w));
      const float d0 = col[0] - ca.x, d1 = col[1] - ca.y, d2 = col[2] - ca.z;
      const float cd = (d0 * d0 + d1 * d1) + d2 * d2;
      const float ex = u - ca.w, ey = v - cb.x;
      const float pd = sqrtf(ex * ex + ey * ey) * s2scale;
      const bool zpair = z_valid && (cc.w & 1);
      const float dd = zpair ? fabsf(zc - cb.y) : 0.0f;
      float d = (cd * w_col + pd * w_spa) + dd * w_dep;
      const bool npair = zn_valid && (cc.w & 2);  // zpair, both normals valid
      const float dot = (nm[0] * cb.z + nm[1] * cb.w) + nm[2] * __int_as_float(cc.x);
      const float nd = npair ? 65025.0f * (1.0f - fmaxf(dot, 0.0f)) : 0.0f;
      d = d + nd * w_nor;
      if (d < bd) {
        bd = d;
        best = i;
      }
    };
    for (int i = 0; i < m0; ++i) consider(i);
    if (out_of_grid && INIT_DISTANCE < bd) {
      bd = INIT_DISTANCE;
      best = OUT_OF_GRID;
    }
    for (int i = m0; i < m; ++i) consider(i);
    int bl = -1, bj = -1;
    if (best == OUT_OF_GRID) {
      bl = own;
      bj = own_slot;
    } else if (best >= 0) {
      const int4 cc = reinterpret_cast<const int4*>(cand)[3 * best + 2];
      bl = cc.y;
      bj = cc.z;
    }
    if (apply_invalid && zc < VALID_DEPTH_MM) {  // NormalAdaptiveSuperpixel.cu:346-352
      bl = -1;
      bd = 0.0f;
      bj = -1;
    }
    labels[pix] = bl;
    dist[pix] = bd;
    s_slot[p] = bj;
  }
};

// Dynamic shared memory of assign_analyze_kernel: the warps' double
// partials [NW][n*13], the candidate table [n][3] 16-byte rows, the
// candidates' x, y [n][2] and the pixels' slots [P].
size_t assign_smem(const Cells& c) {
  const size_t n = 4 * static_cast<size_t>(c.r) * c.r;
  return sizeof(double) * NW * n * N_ANALYZE + sizeof(float4) * 3 * n + sizeof(float) * 2 * n +
         sizeof(int) * c.bs_y * c.bs_x;
}

// The first assignment of the cell's pixels, then the analyze sums of the
// labels it gave: two phases over the same walk, so the candidate sweep
// runs without the run sums' registers.
__global__ void __launch_bounds__(NT, 3)
assign_analyze_kernel(const float* __restrict__ color, const float* __restrict__ points,
                      const float* __restrict__ normals, const float* __restrict__ cand,
                      int* __restrict__ labels, float* __restrict__ dist,
                      float* __restrict__ out, Cells c, float lo, float hi, float w_col,
                      float w_spa, float w_dep, float w_nor, float s2scale,
                      int apply_invalid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 4 * c.r * c.r, nF = n * N_ANALYZE;
  const int b = blockIdx.z, cy = blockIdx.y, cx = blockIdx.x;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double* part = reinterpret_cast<double*>(smem);              // [NW][n*13]
  float4* s_cand = reinterpret_cast<float4*>(part + NW * nF);  // [m][3]
  float* fld = reinterpret_cast<float*>(s_cand + 3 * n);       // [n][2] by slot
  int* s_slot = reinterpret_cast<int*>(fld + 2 * n);           // [P]
  zero_partials(part, NW * nF);
  // the in-grid candidates, dy-major; cand: [B, rows*cols, 9] = rgb 3, x,
  // y, center z, normal 3
  const int r = c.r, two_r = 2 * r;
  const int dy0 = max(-r, -cy), dy1 = min(r, c.rows - cy);
  const int dx0 = max(-r, -cx), dx1 = min(r, c.cols - cx);
  const int mw = dx1 - dx0, m = (dy1 - dy0) * mw;
  for (int i = threadIdx.x; i < m; i += NT) {
    const int dy = dy0 + i / mw, dx = dx0 + i % mw;
    const int id = (cy + dy) * c.cols + (cx + dx), slot = (dy + r) * two_r + (dx + r);
    const float* src = cand + (static_cast<size_t>(b) * c.rows * c.cols + id) * 9;
    float e[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) e[k] = src[k];
    const bool z_valid = e[5] > VALID_DEPTH_MM;
    s_cand[3 * i] = make_float4(e[0], e[1], e[2], e[3]);
    s_cand[3 * i + 1] = make_float4(e[4], e[5], e[6], e[7]);
    reinterpret_cast<int4*>(s_cand)[3 * i + 2] =
        make_int4(__float_as_int(e[8]), id, slot,
                  (z_valid ? 1 : 0) | (z_valid && normal_valid(e + 6) ? 2 : 0));
    fld[2 * slot] = e[3];
    fld[2 * slot + 1] = e[4];
  }
  // the first out-of-grid candidate comes before every in-grid one unless
  // the offsets' first row and column are in the grid
  const bool out_of_grid = m < n;
  const int m0 = (dy0 > -r || dx0 > -r) ? 0 : dx1 < r ? mw : m;
  __syncthreads();
  const size_t frame = static_cast<size_t>(b) * c.H * c.W;
  const Walk walk(c, w);
  const Assigner assign{color + 3 * frame, points + 3 * frame, normals + 3 * frame,
                        labels + frame, dist + frame, s_cand, s_slot, m, m0, out_of_grid,
                        cy * c.cols + cx, r * two_r + r, c.W, cx * c.bs_x, cy * c.bs_y,
                        apply_invalid, w_col, w_spa, w_dep, w_nor, s2scale};
  Cursor at(c, walk.p0 + lane);
  for (int k = 0; k < walk.rounds; ++k) {
    if (walk.live(k, lane)) assign.pixel(at.px, at.py, at.py * c.bs_x + at.px);
    at.next();
  }
  // each lane reads back only the slots of its own pixels
  NaspSource<false, AssignedSlot> src{{s_slot}, color + 3 * frame, points + 3 * frame,
                                      normals + 3 * frame, fld, Cursor(c, walk.p0 + lane),
                                      c.W, cx * c.bs_x, cy * c.bs_y, lo, hi, 1.0f, 1.0f};
  run_sums<N_ANALYZE>(src, walk, N_ANALYZE, nF, part, cell_out(out, c, nF));
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

// A grid of cells that divides the image; blocks per (frame, cell) need
// B and rows within a grid dimension's 65535.
bool make_cells(int B, int H, int W, int rows, int cols, int r, Cells* c) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || rows <= 0 || rows > 65535 || cols <= 0 ||
      r < 1)
    return false;
  if (H % rows != 0 || W % cols != 0) return false;
  *c = Cells{H, W, rows, cols, r, H / rows, W / cols};
  return true;
}

int launched() { return static_cast<int>(cudaGetLastError()); }

constexpr int MAX_DEVICES = 64;

// Dynamic shared memory above 48 KB must be allowed per kernel and device:
// allow the most a block may use once, at the kernel's first such launch on
// each device, so later launches make no driver call for it.
template <auto Kernel>
cudaError_t allow_smem() {
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < MAX_DEVICES;
  if (known && allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(MAX_SMEM));
  if (e == cudaSuccess && known) allowed[dev] = true;
  return e;
}

// Launch Kernel with `smem` bytes of dynamic shared memory (refused above
// what a block may have).
template <auto Kernel, class... Args>
int launch_dyn(dim3 grid, size_t smem, void* stream, Args... args) {
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<Kernel>();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return launched();
}

template <int FT>
int launch_gather(bool vec4, dim3 grid, size_t smem, void* stream, const int* labels,
                  const float* table, float* out, Cells c, int F) {
  return vec4 ? launch_dyn<label_gather_kernel<FT, true>>(grid, smem, stream, labels, table,
                                                          out, c, F)
              : launch_dyn<label_gather_kernel<FT, false>>(grid, smem, stream, labels, table,
                                                           out, c, F);
}

template <int FC>
int launch_label_sums(int vec, dim3 grid, size_t smem, void* stream, const int* labels,
                      const float* feats, float* out, Cells c, int F) {
  if constexpr (FC >= 4) {
    if (vec == 4) {
      return launch_dyn<label_sums_kernel<4, FC>>(grid, smem, stream, labels, feats, out, c, F);
    }
  }
  if constexpr (FC >= 2) {
    if (vec == 2) {
      return launch_dyn<label_sums_kernel<2, FC>>(grid, smem, stream, labels, feats, out, c, F);
    }
  }
  return launch_dyn<label_sums_kernel<1, FC>>(grid, smem, stream, labels, feats, out, c, F);
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
  if (F <= 0 || !make_cells(B, H, W, rows, cols, r, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, B);
  const size_t smem = label_gather_smem(c, F);
  const bool vec4 = (W * F) % 4 == 0 && aligned(out, 16);
  switch (F) {
    case 1: return launch_gather<1>(vec4, grid, smem, stream, labels, table, out, c, F);
    case 3: return launch_gather<3>(vec4, grid, smem, stream, labels, table, out, c, F);
    case 6: return launch_gather<6>(vec4, grid, smem, stream, labels, table, out, c, F);
    default: return launch_gather<0>(vec4, grid, smem, stream, labels, table, out, c, F);
  }
}

// labels [B, H, W] i32; feats [B, H, W, F] f32 (pre-masked), F <= 16;
// out [B, rows*cols*(2r)^2, F] f32.
extern "C" int kde_label_cell_sums(const int* labels, const float* feats, float* out,
                                   int B, int H, int W, int rows, int cols, int r, int F,
                                   void* stream) {
  Cells c;
  if (F <= 0 || F > MAXF || !make_cells(B, H, W, rows, cols, r, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cols, rows, B);
  const size_t smem = label_sums_smem(c, F);
  const int vec = F % 4 == 0 && aligned(feats, 16) ? 4 : F % 2 == 0 && aligned(feats, 8) ? 2 : 1;
  if (F == 1) return launch_label_sums<1>(vec, grid, smem, stream, labels, feats, out, c, F);
  if (F == 2) return launch_label_sums<2>(vec, grid, smem, stream, labels, feats, out, c, F);
  if (F <= 4) return launch_label_sums<4>(vec, grid, smem, stream, labels, feats, out, c, F);
  if (F <= 8) return launch_label_sums<8>(vec, grid, smem, stream, labels, feats, out, c, F);
  return launch_label_sums<16>(vec, grid, smem, stream, labels, feats, out, c, F);
}

// labels [B, H, W] i32; color, points, normals [B, H, W, 3] f32; cand
// [B, rows, cols, 2 | 8] f32 (x, y | x, y, rgb, normal); mode 0 analyze
// (13 features), 1 weighted (14); c2 = 2 sigma_c^2, s2 = 2 sigma_s^2;
// out [B, rows*cols*(2r)^2, 13 | 14] f32.  Any r whose partials fit a
// block's shared memory (nasp_sums_smem).
extern "C" int kde_nasp_cell_sums(const int* labels, const float* color,
                                  const float* points, const float* normals,
                                  const float* cand, float* out, int B, int H, int W,
                                  int rows, int cols, int r, float lo, float hi, int mode,
                                  float c2, float s2, void* stream) {
  Cells c;
  if ((mode != 0 && mode != 1) || !make_cells(B, H, W, rows, cols, r, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cols, rows, B);
  const size_t smem = nasp_sums_smem(c, mode == 1);
  return mode == 1 ? launch_dyn<nasp_sums_kernel<true>>(grid, smem, stream, labels, color,
                                                        points, normals, cand, out, c, lo,
                                                        hi, c2, s2)
                   : launch_dyn<nasp_sums_kernel<false>>(grid, smem, stream, labels, color,
                                                         points, normals, cand, out, c, lo,
                                                         hi, c2, s2);
}

// color, points, normals [B, H, W, 3] f32; cand [B, rows, cols, 9] f32 (rgb,
// x, y, center z, normal); labels [B, H, W] i32, dist [B, H, W] f32 and
// out [B, rows*cols*(2r)^2, 13] f32 are written.  w_* are the distance
// weights and s2scale = s_scale^2, each as the plain version rounds them.
// Any r whose partials fit a block's shared memory (assign_smem).
extern "C" int kde_nasp_assign_analyze(const float* color, const float* points,
                                       const float* normals, const float* cand,
                                       int* labels, float* dist, float* out, int B, int H,
                                       int W, int rows, int cols, int r, float lo, float hi,
                                       float w_col, float w_spa, float w_dep, float w_nor,
                                       float s2scale, int apply_invalid, void* stream) {
  Cells c;
  if (!make_cells(B, H, W, rows, cols, r, &c)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dyn<assign_analyze_kernel>(dim3(cols, rows, B), assign_smem(c), stream, color,
                                           points, normals, cand, labels, dist, out, c, lo, hi,
                                           w_col, w_spa, w_dep, w_nor, s2scale, apply_invalid);
}
