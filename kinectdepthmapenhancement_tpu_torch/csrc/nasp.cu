// NASP cell kernels: label-cell gather, and three per-(cell, candidate)
// sums kernels on one reduction: label-cell sums, NASP update sums and the
// fused first assignment + analyze sums; the label counts and the float
// label sums of the global label index; and the global route's SLIC
// assignment sweep.
//
// Replace the TPU kernels of kinectdepthmapenhancement_tpu/ops/pallas_nasp.py:
//   kde_label_cell_gather    label_cell_gather        (:340, body :301)
//   kde_label_cell_sums      label_cell_sums          (:224, body :183)
//   kde_nasp_cell_sums       nasp_cell_sums           (:654, body :63)
//   kde_nasp_assign_analyze  nasp_assign_and_analyze  (:554, body :400)
// kde_label_counts (label_counts_kernel) and kde_label_sums
// (label_index_sums_kernel + label_index_fold_kernel) replace no TPU
// kernel: the JAX package counts labels and label pairs and sums features
// over the whole [K] id space by one-hot products (slic._GlobalIndex), as
// the port's plain versions do.  Nor does kde_assign_global
// (assign_global_kernel): the JAX package's global sweep (slic.py _assign
// with cell_fast=False) is XLA, as the port's plain version is PyTorch.
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
// No atomics in the cell kernels: each sum has one owner and an order fixed
// by the labels alone, so runs are bitwise repeatable, and a double sum of
// f32 terms is exact for integer-valued features (counts, colours, u, v)
// and for the rest the exact sum rounded once to f32 but for the double
// sum's own error, at most n * 2^-53 * sum|terms| over n terms (the label
// sums below give the bound in full).  The gather only copies.
// Dynamic shared memory above 48 KB is allowed once per kernel and device
// (no kernel here has static shared memory).
//
// Label counts (label_counts_kernel): the pixels of each label (single
// form, [B, K]) or of each label pair (pairs, [B, K, K]: labels_a at a and
// labels_b at c, the 4-neighbour pairs of CCL's adjacency), a pixel with
// either label outside [0, K) dropped, as the one-hot drops it.  One pass
// over the labels, PPT consecutive pixels a thread (two 16-byte loads an
// array where the frame's H * W and the pointers allow).  Labels are
// spatially coherent, so a thread first folds its runs of equal keys; a
// key change flushes the warp: lanes group by key (__match_any_sync), the
// group's count is one __reduce_add_sync, and its first lane adds it to
// the table in device memory by one f32 atomicAdd.  The caller zeroes the
// table (a memset node under a graph).  The atomics are exact: every
// addend and every partial sum is an integer below 2^24 (the wrapper
// holds H * W < 2^24), which f32 represents exactly, so the sum is the
// same in any order: deterministic from run to run and bitwise the
// one-hot product's.  Bound: the bytes, two i32 label planes, 1.7 MB for
// B = 1 pairs at 424x512, ~0.5 us at 3.35 TB/s; launch and the atomics'
// latency set the time at these sizes.
//
// Label sums (label_index_sums_kernel, then label_index_fold_kernel): per
// label in [0, K) the sum of F <= 16 f32 features over its pixels where a
// mask is on, a pixel with a label outside [0, K) dropped and one whose mask
// is off adding nothing (its label still counts as the run's, as its zero
// row counts in the one-hot product).  The float sums of the global index
// (NASP's analyze and weighted updates, the SP / DASP updates off their
// caps, CCL's and the plane stage's fits) on a 424x512 or 640x480 frame.
// Pass 1 cuts each frame into bands of whole 32-pixel rounds, one block a
// band (and a chunk of the labels whose table rows fit shared memory:
// all K = 300 at F <= 16), its nwb warps a contiguous run of the band each
// (index_sums_split: ~two blocks an SM, 1-8 warps a block by the tables'
// size, at most 64 bands a frame).  A warp keeps its own [K, F] double
// table in shared memory (33.6 KB at K = 300, F = 14) and walks its pixels
// in order with lane j holding feature j: the round's 32 labels come in
// coalesced, one a lane, and two ballots say where runs of one label start
// and which pixels add; each lane reads its feature of the 32 pixels (F
// consecutive floats a pixel across the lanes).  Labels are spatially
// coherent, so a lane adds its run of equal labels in a double register
// (a step is one predicated double add) and adds the run into the table
// row when a run starts; the decisions are the warp's, so lanes never
// diverge and never share an address.  Three rounds are in flight ahead of
// the one added: their loads are raw (clamped addresses, no select on a
// loaded value), so nothing waits on them before their round.  The block
// adds its warps' tables in warp order and writes the band's [K, F]
// doubles; pass 2 adds the bands of each (frame, label,
// feature) in band order and rounds to f32 once.  Order: fixed by the
// pixels' order and the split, a function of (B, H * W, K, F) alone; no
// atomics, so every run and graph replay is bitwise the same.  Each sum is
// a double sum of f32 terms rounded once: exact for integer-valued
// features (counts, u, v, colour; partial sums < 2^53).  Otherwise the
// double sum S of a label's n terms is off the exact sum E by at most
// (n - 1) * 2^-53 * sum|terms| (each term passes at most n - 1 double
// adds: run, table, warp fold, band fold), and rounding S to f32 adds half
// an ulp: |out - E| <= ulp(E) / 2 + n * 2^-53 * sum|terms|.  That is within
// 1 ulp of E where sum|terms| / |E| < 2^29 / n (1,747 for n = 307,200, a
// whole 640x480 frame; ~770,000 for a 700-pixel cluster), and otherwise,
// where the terms cancel (centred points or normals), ~3.4e-11 of
// sum|terms| at n = 307,200; the one-hot product's f32 accumulation
// rounds at every step, ~n * 2^-24 * sum|terms|.  Bound: the bytes, one read of the labels, the
// mask and the features, 8 x 217088 x (4 + 1 + 14 * 4) B = 106 MB at B = 8
// on 424x512 (F = 14), ~32 us at 3.35 TB/s; the bands' tables add
// 2 x 33 x 8 x 33.6 KB = 17.7 MB there.  What sets the time: each warp's
// serial walk, ~2 us a round on an H100 at six warps an SM (one table each
// at F = 14, so shared memory caps the warps), one feature a lane (F of
// 32 lanes busy): 0.14 ms a B = 8 call at F = 14 on an H100 80GB HBM3.
//
// Global sweep (assign_global_kernel): one SLIC assignment of the SP, DASP
// or NASP distance (the variant a template parameter) over labels with no
// locality, the global route's (slic._assign_global): a pixel's candidates
// are the (2r)^2 cells around its CURRENT label's cell, dy-major, label -1
// taken as cluster 0's cell; an out-of-grid candidate costs the pixel's
// current distance and names its current label (the fused first
// assignment's cost INIT_DISTANCE instead); the best starts at (+inf, -1)
// and a candidate replaces it on a strict < (the plain version's first
// minimum); then the variant's invalid-depth override (label -1, distance
// 0 where z < 50, when the caller asks).  One thread a pixel, a block a
// 32 x 8 pixel tile of one frame (blockIdx.z).  The block first stages the
// frame's whole cluster table in shared memory as 16-byte rows: (r, g, b,
// x), (y, centre z, n0, n1), and for NASP (n2, the flag "centre z and
// centre normal valid"): 14,400 B at K = 300 for NASP, 9,600 for SP /
// DASP.  A table beyond 48 KB (K > 1,024 for NASP) is not staged: each
// candidate reads its fields through the read-only cache; the choice
// follows from K alone.  Each distance runs in the plain version's
// operation order, with the fused assignment's arithmetic (-fmad=false,
// IEEE sqrtf, the weights and s_scale^2 rounded to f32 as PyTorch rounds a
// Python scalar, 255^2 = 65025.0f), so labels and distances are bitwise
// the plain version's; SP stops after the spatial term, DASP after the
// depth term.  Only the first out-of-grid candidate can win (they all cost
// the same), so it is compared once, at its place in the order.  A width
// tile's first global column x0 shifts u.  Bound: the issue of the sweep,
// 62 instructions a NASP candidate in the staged loop (as many as the
// fused assignment's; 47 DASP, 39 SP: cuobjdump -sass) x 64 (16)
// candidates a pixel: ~0.21 ms a B = 8 424x512 NASP sweep, ~0.055 ms a
// B = 8 640x480 DASP one, at one warp instruction a clock on every
// scheduler; the bytes (label, distance, colour and the points and
// normal planes read, label and distance written: 52 B a NASP pixel, 40 a
// DASP one) ~27 and ~29 us.  The staging adds K rows of L2 reads a block
// (~14 KB for the ~13 KB of its 256 pixels' own bytes).
//
// Width tiles: every cell kernel takes the tile's first cell column c0 and
// its cell columns tc (c0 = 0, tc = cols: the whole frame).  The image is the
// tile [B, H, tc * bs_x]; cells, candidates and cluster ids are those of
// the global grid (cols columns), a pixel's u is its global column, and a
// sums kernel writes the tile's [B, rows*tc*n, F] partials, which the
// caller gathers over the tiles in cell order.  A cell's result depends on
// its own pixels and the global tables only, so a tile's cells are bitwise
// the matching cells of the whole frame.

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
constexpr int NS = 4;          // rounds a sums warp holds: one added, NS - 1 in flight
constexpr int N_ANALYZE = 13;
constexpr int N_WEIGHTED = 14;
constexpr float VALID_DEPTH_MM = 50.0f;
constexpr float INVALID_NORMAL = -1.0f;
constexpr float INIT_DISTANCE = 999999.9f;  // the JAX package's slic.INIT_DISTANCE in f32
constexpr unsigned ALL = 0xffffffffu;

// H x W: the tile; rows x cols: the global grid; the tile holds cell
// columns [c0, c0 + tc).
struct Cells {
  int H, W, rows, cols, r, bs_y, bs_x, c0, tc;
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

// The block's cell's [n * F] rows of the tile's [B, rows*tc*n, F] partial
// table (block x: the cell column within the tile).
__device__ __forceinline__ float* cell_out(float* out, const Cells& c, int nF) {
  const size_t cell = (static_cast<size_t>(blockIdx.z) * c.rows + blockIdx.y) * c.tc + blockIdx.x;
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
  const int b = blockIdx.z, cy = blockIdx.y, tx = blockIdx.x, cx = c.c0 + tx;
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
                            Cursor(c, walk.p0 + lane), F, c.W, tx * c.bs_x, cy * c.bs_y,
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
// (fld[j * NFLD]).  x0 is the cell's first column in the tile, xg the
// tile's first global column (u = xg + x).
template <bool WEIGHTED, class SlotOf>
struct NaspSource {
  static constexpr int F = WEIGHTED ? N_WEIGHTED : N_ANALYZE;
  static constexpr int NFLD = WEIGHTED ? 8 : 2;  // x, y (, rgb 3, normal 3)
  SlotOf slot_of;
  const float *color, *points, *normals;  // the frame's [H, W, 3]
  const float* fld;                       // [n][NFLD]
  Cursor at;
  int W, x0, y0, xg;
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
      if (slot >= 0 && !nasp_features(WEIGHTED, static_cast<float>(xg + x), static_cast<float>(y),
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
  const int b = blockIdx.z, cy = blockIdx.y, tx = blockIdx.x, cx = c.c0 + tx;
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
          tx * c.bs_x, cy * c.bs_y, c.c0 * c.bs_x, lo, hi, c2, s2};
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
  int m, m0, out_of_grid, own, own_slot, W, x0, y0, xg, apply_invalid;
  float w_col, w_spa, w_dep, w_nor, s2scale;

  __device__ void pixel(int px, int py, int p) const {
    const int x = x0 + px, y = y0 + py;
    const size_t pix = static_cast<size_t>(y) * W + x;
    const float col[3] = {color[3 * pix], color[3 * pix + 1], color[3 * pix + 2]};
    const float zc = points[3 * pix + 2];
    const float nm[3] = {normals[3 * pix], normals[3 * pix + 1], normals[3 * pix + 2]};
    float u = static_cast<float>(xg + x), v = static_cast<float>(y);
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
  const int b = blockIdx.z, cy = blockIdx.y, tx = blockIdx.x, cx = c.c0 + tx;
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
                        cy * c.cols + cx, r * two_r + r, c.W, tx * c.bs_x, cy * c.bs_y,
                        c.c0 * c.bs_x, apply_invalid, w_col, w_spa, w_dep, w_nor, s2scale};
  Cursor at(c, walk.p0 + lane);
  for (int k = 0; k < walk.rounds; ++k) {
    if (walk.live(k, lane)) assign.pixel(at.px, at.py, at.py * c.bs_x + at.px);
    at.next();
  }
  // each lane reads back only the slots of its own pixels
  NaspSource<false, AssignedSlot> src{{s_slot}, color + 3 * frame, points + 3 * frame,
                                      normals + 3 * frame, fld, Cursor(c, walk.p0 + lane),
                                      c.W, tx * c.bs_x, cy * c.bs_y, c.c0 * c.bs_x, lo, hi,
                                      1.0f, 1.0f};
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
  // cell column lies in (lx - r, lx + r]: a window of global columns
  for (int rel = tid; rel < nrel; rel += NT) {
    const int lx = rel % c.cols;
    s_win[rel] = make_int2((lx - c.r + 1) * c.bs_x, (lx + c.r + 1) * c.bs_x);
  }
  __syncthreads();
  const size_t row = (static_cast<size_t>(b) * c.H + y) * c.W;
  const int xg = c.c0 * c.bs_x;  // the tile's first global column
  for (int x = tid; x < c.W; x += NT) {
    const int rel = labels[row + x] - base;
    int off = -1;
    if (rel >= 0 && rel < nrel) {
      const int2 win = s_win[rel];
      if (xg + x >= win.x && xg + x < win.y) off = rel * F;
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

// ------------------------------------------------------------ label counts

constexpr int PPT = 8;  // consecutive pixels a label-counts thread folds

// The key of a pixel: label a (single form) or a * K + b (pairs); -1 when
// a label lies outside [0, K), as tables.one_hot drops it.
template <bool PAIRS>
__device__ __forceinline__ int count_key(int a, int b, int K) {
  const bool in_a = a >= 0 && a < K;
  if (!PAIRS) return in_a ? a : -1;
  return in_a && b >= 0 && b < K ? a * K + b : -1;
}

// One flush of the warp's runs: lanes with the same key (-1: nothing to
// add) form a group, whose first lane adds the group's count to the table.
__device__ __forceinline__ void flush_counts(float* table, int key, unsigned count, int lane) {
  const unsigned peers = __match_any_sync(ALL, key);
  const unsigned total = __reduce_add_sync(peers, count);
  if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(table + key, static_cast<float>(total));
}

// Histogram of a frame's labels (single form: table [K]) or label pairs
// (pairs: table [K, K], entry a * K + b): block (x, frame), thread t takes
// the PPT consecutive pixels from (x * NT + t) * PPT of the frame's N,
// 16-byte loads when VEC.  Every thread runs every step (no early exit):
// the warp's collectives take all lanes.
template <bool PAIRS, bool VEC>
__global__ void __launch_bounds__(NT)
label_counts_kernel(const int* __restrict__ labels_a, const int* __restrict__ labels_b,
                    float* __restrict__ out, int N, int K) {
  const size_t frame = blockIdx.y;
  const int* a = labels_a + frame * N;
  const int* b = PAIRS ? labels_b + frame * N : nullptr;
  float* table = out + frame * (PAIRS ? static_cast<size_t>(K) * K : static_cast<size_t>(K));
  const int p0 = (blockIdx.x * NT + threadIdx.x) * PPT;
  int la[PPT], lb[PPT];
#pragma unroll
  for (int j = 0; j < PPT; j += (VEC ? 4 : 1)) {
    if (VEC) {
      int4 va = make_int4(-1, -1, -1, -1), vb = va;
      if (p0 + j < N) {  // N % 4 == 0: a quad lies in the frame or past it
        va = *reinterpret_cast<const int4*>(a + p0 + j);
        if (PAIRS) vb = *reinterpret_cast<const int4*>(b + p0 + j);
      }
      la[j] = va.x, la[j + 1] = va.y, la[j + 2] = va.z, la[j + 3] = va.w;
      lb[j] = vb.x, lb[j + 1] = vb.y, lb[j + 2] = vb.z, lb[j + 3] = vb.w;
    } else {
      const bool in = p0 + j < N;
      la[j] = in ? a[p0 + j] : -1;
      lb[j] = in && PAIRS ? b[p0 + j] : -1;
    }
  }
  const int lane = threadIdx.x & 31;
  // the thread's run of equal keys; a key change flushes the run before it
  int key = count_key<PAIRS>(la[0], lb[0], K);
  unsigned run = 1;
#pragma unroll
  for (int j = 1; j < PPT; ++j) {
    const int kj = count_key<PAIRS>(la[j], lb[j], K);
    const bool change = kj != key;
    if (__any_sync(ALL, change && key >= 0))
      flush_counts(table, change ? key : -1, run, lane);
    if (change) {
      key = kj;
      run = 0;
    }
    ++run;
  }
  flush_counts(table, key, run, lane);
}

// -------------------------------------------------------------- label sums

constexpr int ROUND = 32;             // pixels a label-sums warp takes a round
constexpr int SUMS_BLOCKS = 264;      // blocks a label-sums call aims at: two an SM of 132
constexpr int SUMS_MOST_BANDS = 64;   // bands a frame at most: the fold's terms an output
constexpr int SUMS_LEAST_ROUNDS = 4;  // rounds a warp is given at least
// a block's tables: two blocks an SM (228 KB, 1 KB a block reserved)
constexpr size_t SUMS_TABLES = 115712;

// The split of a label-sums call over the card: each frame's N pixels in
// `bands` bands of `per` pixels (the last shorter), one block a band and
// chunk of kc labels; a band's nwb warps take `wper` pixels each (rounds
// of 32, the last warps' shorter or empty).  A function of (B, N, K, F)
// alone, so the order of every sum is too.
struct IndexSums {
  int N, K, F, kc, chunks, nwb, bands, per, wper;
};

bool index_sums_split(int B, int N, int K, int F, IndexSums* g) {
  if (B <= 0 || B > 65535 || N <= 0 || N > INT32_MAX - 8 * ROUND || K <= 0 ||
      F <= 0 || F > MAXF || static_cast<long long>(B) * K * F > INT32_MAX)
    return false;
  const size_t row = sizeof(double) * F;
  const int kc = static_cast<int>(std::min<size_t>(K, MAX_SMEM / row));
  const int chunks = (K + kc - 1) / kc;
  if (chunks > 65535) return false;
  const int nwb = static_cast<int>(std::clamp<size_t>(SUMS_TABLES / (row * kc), 1, NW));
  const long long cover = static_cast<long long>(B) * chunks;
  const long long most = std::clamp<long long>(
      N / (static_cast<long long>(ROUND) * SUMS_LEAST_ROUNDS * nwb), 1, SUMS_MOST_BANDS);
  const long long want = std::clamp<long long>((SUMS_BLOCKS + cover - 1) / cover, 1, most);
  const long long per = ((N + want - 1) / want + ROUND - 1) / ROUND * ROUND;
  const long long wper = ((per + nwb - 1) / nwb + ROUND - 1) / ROUND * ROUND;
  *g = IndexSums{N, K, F, kc, chunks, nwb, static_cast<int>((N + per - 1) / per),
                 static_cast<int>(per), static_cast<int>(wper)};
  return true;
}

// Pass 1: block (band, chunk, frame) sums the F features of the band's
// pixels per label of its chunk [k0, k0 + kn), writing the band's rows of
// part [B, bands, K, F] (doubles) whole.  Lane j of a warp holds feature j
// (lanes >= F only follow); the warp walks its pixels in order, 32 a
// round, each lane reading its round pixel's label and mask byte.  The
// lane's run sum of
// one label grows while the label stays the same and is added into the
// warp's own table row when it changes; where runs start and which pixels
// add are the warp's ballots, so every decision is uniform, no lane
// diverges, no two lanes write one address, and a step of the walk is a
// predicated double add.  Three rounds are in flight ahead of the one
// added.  After a barrier the block adds its warps' tables in warp order.
__global__ void __launch_bounds__(NT)
label_index_sums_kernel(const int* __restrict__ labels, const unsigned char* __restrict__ mask,
                        const float* __restrict__ feats, double* __restrict__ part, IndexSums g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int band = blockIdx.x, k0 = blockIdx.y * g.kc, b = blockIdx.z, F = g.F;
  const int kn = min(g.kc, g.K - k0), nF = kn * F;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double* tabs = reinterpret_cast<double*>(smem);  // [nwb][kn * F]
  for (int i = threadIdx.x; i < g.nwb * nF; i += blockDim.x) tabs[i] = 0.0;
  __syncthreads();
  const size_t frame = static_cast<size_t>(b) * g.N;
  const int* lab = labels + frame;
  const unsigned char* msk = mask == nullptr ? nullptr : mask + frame;
  const float* fe = feats + frame * F;
  const int b1 = min(band * g.per + g.per, g.N);
  const int p0 = band * g.per + w * g.wper, p1 = min(p0 + g.wper, b1);  // p0 >= p1: none
  double* tab = tabs + w * nF;
  const bool mine = lane < F;  // the lane holds a feature
  int cur = -1;                // the open run's label (-1: none) and the lane's sum of it
  double acc = 0.0;

  // the round at p, loaded raw: the lane's pixel's label and mask byte,
  // and feature `lane` of the round's 32 pixels.  Nothing here reads a
  // loaded value (addresses past the warp's pixels or the features read
  // the frame's pixel 0), so the loads stay in flight until the round is
  // added
  const int fl = min(lane, F - 1);
  const auto fetch = [&](int p, int& rl, int& rm, float (&f)[ROUND]) {
    const int q = p + lane < p1 ? p + lane : 0;
    rl = lab[q];
    rm = msk == nullptr ? 1 : msk[q];
#pragma unroll
    for (int i = 0; i < ROUND; ++i) {
      f[i] = fe[static_cast<size_t>(p + i < p1 ? p + i : 0) * F + fl];
    }
  };
  // add the round at p: the lane's pixel's label (-1: dropped), a run
  // starting at each pixel whose label differs from the pixel's before
  // (the open run of the round before carrying on); the warp's ballots
  // make each step's decision uniform
  const auto fold = [&](int p, int rl, int rm, const float (&f)[ROUND]) {
    int l = -1;
    const unsigned u = static_cast<unsigned>(rl) - static_cast<unsigned>(k0);
    if (p + lane < p1 && u < static_cast<unsigned>(kn)) l = static_cast<int>(u);
    const int before = __shfl_up_sync(ALL, l, 1);
    const unsigned starts = __ballot_sync(ALL, l != (lane == 0 ? cur : before));
    const unsigned adds = __ballot_sync(ALL, l >= 0 && rm != 0);
#pragma unroll
    for (int i = 0; i < ROUND; ++i) {
      if (starts & (1u << i)) {
        if (cur >= 0 && mine) tab[cur * F + lane] += acc;
        cur = __shfl_sync(ALL, l, i);
        acc = 0.0;
      }
      if (adds & (1u << i)) acc += static_cast<double>(f[i]);
    }
  };
  // round r in buffer r % NS, fetched NS - 1 rounds ahead of its fold
  int rl[NS], rm[NS];
  float f[NS][ROUND];
#pragma unroll
  for (int s = 0; s + 1 < NS; ++s) fetch(p0 + s * ROUND, rl[s], rm[s], f[s]);
  for (int p = p0; p < p1; p += NS * ROUND) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int ahead = (s + NS - 1) % NS;
      fetch(p + (s + NS - 1) * ROUND, rl[ahead], rm[ahead], f[ahead]);
      fold(p + s * ROUND, rl[s], rm[s], f[s]);
      if (p + (s + 1) * ROUND >= p1) goto walked;
    }
  }
walked:
  if (cur >= 0 && mine) tab[cur * F + lane] += acc;
  __syncthreads();
  double* out = part + ((static_cast<size_t>(b) * g.bands + band) * g.K + k0) * F;
  for (int o = threadIdx.x; o < nF; o += blockDim.x) {
    double a = 0.0;
    for (int k = 0; k < g.nwb; ++k) a += tabs[k * nF + o];
    out[o] = a;
  }
}

// Pass 2: out [B, K*F] f32 = the bands of part [B, bands, K*F] added in
// band order, rounded once.
__global__ void __launch_bounds__(NT)
label_index_fold_kernel(const double* __restrict__ part, float* __restrict__ out, int B,
                        int bands, int KF) {
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<long long>(B) * KF) return;
  const long long b = i / KF;
  const double* src = part + b * bands * KF + (i - b * KF);
  double a = 0.0;
#pragma unroll 16
  for (int j = 0; j < bands; ++j) a += src[static_cast<long long>(j) * KF];
  out[i] = static_cast<float>(a);
}

constexpr int SWEEP_TX = 32;                   // a sweep block's tile: 32 x 8 pixels
constexpr int SWEEP_TY = NT / SWEEP_TX;
constexpr size_t SWEEP_STAGE_MAX = 48 * 1024;  // cluster-table bytes a block stages
constexpr int SWEEP_SP = 0, SWEEP_DASP = 1, SWEEP_NASP = 2;

// A variant's cluster fields (rgb, x, y; centre z; normal: slic.
// _cluster_fields) and its 16-byte rows a cluster.
template <int V>
struct Sweep {
  static constexpr int F = V == SWEEP_SP ? 5 : V == SWEEP_DASP ? 6 : 9;
  static constexpr int NR = V == SWEEP_NASP ? 3 : 2;
};

struct SweepArgs {
  const int* labels;    // [B, H, W], the current labels
  const float* dist;    // [B, H, W], the current distances
  const float* fields;  // [B, K, F]
  const float *color, *points, *normals;  // [B, H, W, 3]: points unread by SP, normals but by NASP
  int* labels_out;      // [B, H, W]
  float* dist_out;      // [B, H, W]
  int H, W, K, rows, cols, r, x0, apply_invalid;
  float w_col, w_spa, w_dep, w_nor, s2scale;
};

// Cluster `id`'s rows from the frame's fields [K, F], read through the
// read-only cache: (r, g, b, x), (y, centre z, n0, n1), (n2, 1 where the
// centre z and the centre normal are valid, else 0).
template <int V>
__device__ __forceinline__ void sweep_rows(const float* __restrict__ fields, int id, float4* row) {
  constexpr int F = Sweep<V>::F;
  const float* f = fields + static_cast<size_t>(id) * F;
  float e[9] = {};
#pragma unroll
  for (int k = 0; k < F; ++k) e[k] = __ldg(f + k);
  row[0] = make_float4(e[0], e[1], e[2], e[3]);
  row[1] = make_float4(e[4], e[5], e[6], e[7]);
  if constexpr (V == SWEEP_NASP) {
    const bool valid = e[5] > VALID_DEPTH_MM && normal_valid(e + 6);
    row[2] = make_float4(e[8], valid ? 1.0f : 0.0f, 0.0f, 0.0f);
  }
}

struct SweepPixel {
  float col[3], nm[3], u, v, z;
  bool z_valid, zn_valid;  // z > 50; and the normal valid
};

// A variant's distance of the pixel to a candidate's rows, in the plain
// version's operation order (slic._distance; Assigner::pixel's arithmetic).
template <int V>
__device__ __forceinline__ float sweep_distance(const float4* c, const SweepPixel& p,
                                                const SweepArgs& s) {
  const float d0 = p.col[0] - c[0].x, d1 = p.col[1] - c[0].y, d2 = p.col[2] - c[0].z;
  const float cd = (d0 * d0 + d1 * d1) + d2 * d2;
  const float ex = p.u - c[0].w, ey = p.v - c[1].x;
  const float pd = sqrtf(ex * ex + ey * ey) * s.s2scale;
  float d = cd * s.w_col + pd * s.w_spa;
  if constexpr (V != SWEEP_SP) {
    const bool zpair = p.z_valid && c[1].y > VALID_DEPTH_MM;
    const float dd = zpair ? fabsf(p.z - c[1].y) : 0.0f;
    d = d + dd * s.w_dep;
  }
  if constexpr (V == SWEEP_NASP) {
    const bool npair = p.zn_valid && c[2].y != 0.0f;  // zpair, both normals valid
    const float dot = (p.nm[0] * c[1].z + p.nm[1] * c[1].w) + p.nm[2] * c[2].x;
    const float nd = npair ? 65025.0f * (1.0f - fmaxf(dot, 0.0f)) : 0.0f;
    d = d + nd * s.w_nor;
  }
  return d;
}

// One sweep of a block's 32 x 8 pixels of frame blockIdx.z; STAGED: the
// frame's cluster table in shared memory, [K][NR] 16-byte rows.
template <int V, bool STAGED>
__global__ void __launch_bounds__(NT)
assign_global_kernel(SweepArgs s) {
  constexpr int NR = Sweep<V>::NR;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* tab = reinterpret_cast<float4*>(smem);
  const int b = blockIdx.z;
  const float* fields = s.fields + static_cast<size_t>(b) * s.K * Sweep<V>::F;
  if constexpr (STAGED) {
    for (int i = threadIdx.x; i < s.K; i += NT) {
      float4 row[3];
      sweep_rows<V>(fields, i, row);
#pragma unroll
      for (int k = 0; k < NR; ++k) tab[NR * i + k] = row[k];
    }
    __syncthreads();
  }
  const int x = blockIdx.x * SWEEP_TX + threadIdx.x % SWEEP_TX;
  const int y = blockIdx.y * SWEEP_TY + threadIdx.x / SWEEP_TX;
  if (x >= s.W || y >= s.H) return;
  const size_t pix = (static_cast<size_t>(b) * s.H + y) * s.W + x;
  SweepPixel p;
#pragma unroll
  for (int k = 0; k < 3; ++k) p.col[k] = s.color[3 * pix + k];
  p.u = static_cast<float>(s.x0 + x);
  p.v = static_cast<float>(y);
  p.z = 0.0f;
  p.z_valid = p.zn_valid = false;
  if constexpr (V != SWEEP_SP) {
    p.z = s.points[3 * pix + 2];
    p.z_valid = p.z > VALID_DEPTH_MM;
  }
  if constexpr (V == SWEEP_NASP) {
#pragma unroll
    for (int k = 0; k < 3; ++k) p.nm[k] = s.normals[3 * pix + k];
    p.zn_valid = p.z_valid && normal_valid(p.nm);
  }
  const int lab = s.labels[pix];
  const float cur = s.dist[pix];
  const int lab0 = max(lab, 0), cy = lab0 / s.cols, cx = lab0 - cy * s.cols;
  const int r = s.r;
  // the in-grid offsets [dy0, dy1) x [dx0, dx1) of the label's cell
  const int dy0 = max(-r, -cy), dy1 = min(r, s.rows - cy);
  const int dx0 = max(-r, -cx), dx1 = min(r, s.cols - cx);
  // the in-grid row after which the first out-of-grid candidate comes,
  // dy0 - 1 where it comes first, none (dy0 - 2) where every one is in grid
  int oog_after = dy0 - 2;
  if (dy1 <= dy0 || dx1 <= dx0 || dy0 > -r || dx0 > -r) {
    oog_after = dy0 - 1;
  } else if (dx1 < r) {
    oog_after = dy0;
  } else if (dy1 < r) {
    oog_after = dy1 - 1;
  }
  float bd = INFINITY;
  int bl = -1;
  if (oog_after == dy0 - 1 && cur < bd) {
    bd = cur;
    bl = lab;
  }
  for (int dy = dy0; dy < dy1; ++dy) {
    const int row0 = (cy + dy) * s.cols + cx;
    for (int dx = dx0; dx < dx1; ++dx) {
      float4 c[3];
      if constexpr (STAGED) {
#pragma unroll
        for (int k = 0; k < NR; ++k) c[k] = tab[NR * (row0 + dx) + k];
      } else {
        sweep_rows<V>(fields, row0 + dx, c);
      }
      const float d = sweep_distance<V>(c, p, s);
      if (d < bd) {
        bd = d;
        bl = row0 + dx;
      }
    }
    if (dy == oog_after && cur < bd) {
      bd = cur;
      bl = lab;
    }
  }
  if (V != SWEEP_SP && s.apply_invalid && p.z < VALID_DEPTH_MM) {
    bl = -1;
    bd = 0.0f;
  }
  s.labels_out[pix] = bl;
  s.dist_out[pix] = bd;
}

// A tile of tc whole cell columns [c0, c0 + tc) of a rows x cols grid that
// divides the frame (the tile W = tc cell widths); blocks per (frame, cell)
// need B and rows within a grid dimension's 65535.
bool make_cells(int B, int H, int W, int rows, int cols, int r, int c0, int tc, Cells* c) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || rows <= 0 || rows > 65535 || cols <= 0 ||
      r < 1 || tc <= 0 || c0 < 0 || c0 + tc > cols)
    return false;
  if (H % rows != 0 || W % tc != 0) return false;
  *c = Cells{H, W, rows, cols, r, H / rows, W / tc, c0, tc};
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

// Launch Kernel in blocks of `threads` with `smem` bytes of dynamic shared
// memory (refused above what a block may have).
template <auto Kernel, class... Args>
int launch_block(dim3 grid, int threads, size_t smem, void* stream, Args... args) {
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<Kernel>();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  Kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return launched();
}

template <auto Kernel, class... Args>
int launch_dyn(dim3 grid, size_t smem, void* stream, Args... args) {
  return launch_block<Kernel>(grid, NT, smem, stream, args...);
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

// A variant's sweep, its cluster table staged where it fits SWEEP_STAGE_MAX.
template <int V>
int launch_sweep(const SweepArgs& s, int B, void* stream) {
  const dim3 grid((s.W + SWEEP_TX - 1) / SWEEP_TX, (s.H + SWEEP_TY - 1) / SWEEP_TY, B);
  const size_t smem = sizeof(float4) * Sweep<V>::NR * s.K;
  return smem <= SWEEP_STAGE_MAX
             ? launch_dyn<assign_global_kernel<V, true>>(grid, smem, stream, s)
             : launch_dyn<assign_global_kernel<V, false>>(grid, 0, stream, s);
}

}  // namespace

// labels [B, H, W] i32 (the tile of cell columns [c0, c0 + tc)); table
// [B, rows*cols, F] f32; out [B, H, W, F] f32.
extern "C" int kde_label_cell_gather(const int* labels, const float* table, float* out,
                                     int B, int H, int W, int rows, int cols, int r, int c0,
                                     int tc, int F, void* stream) {
  Cells c;
  if (F <= 0 || !make_cells(B, H, W, rows, cols, r, c0, tc, &c))
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

// labels [B, H, W] i32 (the tile of cell columns [c0, c0 + tc)); feats
// [B, H, W, F] f32 (pre-masked), F <= 16; out [B, rows*tc*(2r)^2, F] f32.
extern "C" int kde_label_cell_sums(const int* labels, const float* feats, float* out,
                                   int B, int H, int W, int rows, int cols, int r, int c0,
                                   int tc, int F, void* stream) {
  Cells c;
  if (F <= 0 || F > MAXF || !make_cells(B, H, W, rows, cols, r, c0, tc, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tc, rows, B);
  const size_t smem = label_sums_smem(c, F);
  const int vec = F % 4 == 0 && aligned(feats, 16) ? 4 : F % 2 == 0 && aligned(feats, 8) ? 2 : 1;
  if (F == 1) return launch_label_sums<1>(vec, grid, smem, stream, labels, feats, out, c, F);
  if (F == 2) return launch_label_sums<2>(vec, grid, smem, stream, labels, feats, out, c, F);
  if (F <= 4) return launch_label_sums<4>(vec, grid, smem, stream, labels, feats, out, c, F);
  if (F <= 8) return launch_label_sums<8>(vec, grid, smem, stream, labels, feats, out, c, F);
  return launch_label_sums<16>(vec, grid, smem, stream, labels, feats, out, c, F);
}

// labels [B, H, W] i32; color, points, normals [B, H, W, 3] f32 (the tile
// of cell columns [c0, c0 + tc)); cand [B, rows, cols, 2 | 8] f32 (x, y |
// x, y, rgb, normal; the global grid); mode 0 analyze (13 features), 1
// weighted (14); c2 = 2 sigma_c^2, s2 = 2 sigma_s^2; out
// [B, rows*tc*(2r)^2, 13 | 14] f32.  Any r whose partials fit a block's
// shared memory (nasp_sums_smem).
extern "C" int kde_nasp_cell_sums(const int* labels, const float* color,
                                  const float* points, const float* normals,
                                  const float* cand, float* out, int B, int H, int W,
                                  int rows, int cols, int r, int c0, int tc, float lo,
                                  float hi, int mode, float c2, float s2, void* stream) {
  Cells c;
  if ((mode != 0 && mode != 1) || !make_cells(B, H, W, rows, cols, r, c0, tc, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tc, rows, B);
  const size_t smem = nasp_sums_smem(c, mode == 1);
  return mode == 1 ? launch_dyn<nasp_sums_kernel<true>>(grid, smem, stream, labels, color,
                                                        points, normals, cand, out, c, lo,
                                                        hi, c2, s2)
                   : launch_dyn<nasp_sums_kernel<false>>(grid, smem, stream, labels, color,
                                                         points, normals, cand, out, c, lo,
                                                         hi, c2, s2);
}

// color, points, normals [B, H, W, 3] f32 (the tile of cell columns
// [c0, c0 + tc)); cand [B, rows, cols, 9] f32 (rgb, x, y, center z, normal;
// the global grid); labels [B, H, W] i32, dist [B, H, W] f32 and out
// [B, rows*tc*(2r)^2, 13] f32 are written.  w_* are the distance weights
// and s2scale = s_scale^2, each as the plain version rounds them.  Any r
// whose partials fit a block's shared memory (assign_smem).
extern "C" int kde_nasp_assign_analyze(const float* color, const float* points,
                                       const float* normals, const float* cand,
                                       int* labels, float* dist, float* out, int B, int H,
                                       int W, int rows, int cols, int r, int c0, int tc,
                                       float lo, float hi, float w_col, float w_spa,
                                       float w_dep, float w_nor, float s2scale,
                                       int apply_invalid, void* stream) {
  Cells c;
  if (!make_cells(B, H, W, rows, cols, r, c0, tc, &c))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_dyn<assign_analyze_kernel>(dim3(tc, rows, B), assign_smem(c), stream, color,
                                           points, normals, cand, labels, dist, out, c, lo, hi,
                                           w_col, w_spa, w_dep, w_nor, s2scale, apply_invalid);
}

// labels_a [B, N] i32 (N = H * W of the frame or tile); labels_b [B, N] i32
// or null; out [B, K, K] f32 (pairs) or [B, K] (labels_b null), zeroed by
// the caller: each pixel with both labels in [0, K) adds 1 at (a, b) (at a).
// N < 2^24, so every count is exact in f32 in any order of addition.
extern "C" int kde_label_counts(const int* labels_a, const int* labels_b, float* out, int B,
                                int N, int K, void* stream) {
  const bool pairs = labels_b != nullptr;
  if (B <= 0 || B > 65535 || N <= 0 || N >= (1 << 24) || K <= 0 ||
      (pairs && static_cast<long long>(K) * K > INT32_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + NT * PPT - 1) / (NT * PPT), B);
  const bool vec = N % 4 == 0 && aligned(labels_a, 16) && (!pairs || aligned(labels_b, 16));
  if (pairs) {
    return vec ? launch_dyn<label_counts_kernel<true, true>>(grid, 0, stream, labels_a,
                                                               labels_b, out, N, K)
               : launch_dyn<label_counts_kernel<true, false>>(grid, 0, stream, labels_a,
                                                                labels_b, out, N, K);
  }
  return vec ? launch_dyn<label_counts_kernel<false, true>>(grid, 0, stream, labels_a,
                                                              labels_b, out, N, K)
             : launch_dyn<label_counts_kernel<false, false>>(grid, 0, stream, labels_a,
                                                               labels_b, out, N, K);
}

// The bands of a kde_label_sums call (its scratch is [B, bands, K, F]
// doubles), or -1 for arguments it refuses: the split's one source, which
// the wrapper asks once per shape and kde_label_sums holds its scratch to.
extern "C" int kde_label_sums_bands(int B, int N, int K, int F) {
  IndexSums g;
  return index_sums_split(B, N, K, F, &g) ? g.bands : -1;
}

// labels [B, N] i32 (N = H * W of the frame); mask [B, N] bytes 0 / 1 or
// null (every pixel); feats [B, N, F] f32, F <= 16; part [B, bands, K, F]
// f64 scratch, bands from kde_label_sums_bands; out [B, K, F] f32, written
// whole: per label in [0, K) the sum of its pixels' features where the
// mask is on (a pixel whose label lies outside [0, K) is dropped).
extern "C" int kde_label_sums(const int* labels, const unsigned char* mask, const float* feats,
                              double* part, float* out, int B, int N, int K, int F, int bands,
                              void* stream) {
  IndexSums g;
  if (!index_sums_split(B, N, K, F, &g) || g.bands != bands)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = launch_block<label_index_sums_kernel>(
      dim3(g.bands, g.chunks, B), 32 * g.nwb, sizeof(double) * g.nwb * g.kc * F, stream, labels,
      mask, feats, part, g);
  if (e != 0) return e;
  const long long total = static_cast<long long>(B) * K * F;
  return launch_block<label_index_fold_kernel>(dim3(static_cast<unsigned>((total + NT - 1) / NT)),
                                               NT, 0, stream, part, out, B, bands, K * F);
}

// labels [B, H, W] i32 and dist [B, H, W] f32: the current state; fields
// [B, rows*cols, 5 | 6 | 9] f32 (rgb, x, y; centre z; normal: variant 0 SP,
// 1 DASP, 2 NASP); color, points, normals [B, H, W, 3] f32 (points null
// for SP, normals null but for NASP), columns [x0, x0 + W) of the frame;
// labels_out, dist_out [B, H, W] written: the sweep over each pixel's
// (2r)^2 cells around its label's, then the invalid-depth override where
// apply_invalid (DASP and NASP).  w_* the distance weights and s2scale =
// s_scale^2, each as the plain version rounds them.
extern "C" int kde_assign_global(const int* labels, const float* dist, const float* fields,
                                 const float* color, const float* points, const float* normals,
                                 int* labels_out, float* dist_out, int B, int H, int W,
                                 int rows, int cols, int r, int variant, int x0, float w_col,
                                 float w_spa, float w_dep, float w_nor, float s2scale,
                                 int apply_invalid, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || (H + SWEEP_TY - 1) / SWEEP_TY > 65535 ||
      rows <= 0 || cols <= 0 || static_cast<long long>(rows) * cols > INT32_MAX / 2 || r < 1 ||
      x0 < 0 || variant < SWEEP_SP || variant > SWEEP_NASP ||
      (variant != SWEEP_SP && points == nullptr) || (variant == SWEEP_NASP && normals == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const SweepArgs s{labels, dist, fields, color, points, normals, labels_out, dist_out, H, W,
                    rows * cols, rows, cols, r, x0, apply_invalid, w_col, w_spa, w_dep, w_nor,
                    s2scale};
  switch (variant) {
    case SWEEP_SP: return launch_sweep<SWEEP_SP>(s, B, stream);
    case SWEEP_DASP: return launch_sweep<SWEEP_DASP>(s, B, stream);
    default: return launch_sweep<SWEEP_NASP>(s, B, stream);
  }
}
