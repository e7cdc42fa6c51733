// All-pairs windowed Sakoe-Chiba DTW, one warp per (query, template) pair.
//
// Replaces the TPU kernel dsp_tpu/kernels/dtw_fused_banded.py
// (dtw_batch_fused_banded / _kernel): queries [B,T,F] x bank [K,U,F] ->
// distances [B,K] = D[la-1, lb-1] / (q_len + bank_len).  It computes the
// same cells as the JAX package's plain scan (dsp_tpu/ops/dtw.py) and as
// this package's plain version (dsp_tpu_torch/ops/dtw.py:dtw_batch):
//
//   cell (i, j) of pair (a, b) is valid iff i < la, j < lb,
//   |j*lam1 - i*lbm1| <= r2 (integer Sakoe-Chiba band, lam1 = max(la-1, 1),
//   lbm1 = lb-1, r2 = floor(f32(max(1, band_frac*max(la, lb))) * f32(lam1))),
//   and j lies in [off_b, off_b + W) for row block b = i / rb, where off_b
//   follows the integer recursion of ops/dtw.py:window_offsets and
//   (W, S_MAX, rb) come from window_plan.plan_window on the padded shapes.
//   Invalid cells are exactly BIG = 1e30.
//
// The local cost is the exact sqrt(sum (a-b)^2) in fp32, summed over the
// features in ascending order (its square with `squared`), not the TPU's
// |a|^2 + |b|^2 - 2ab expansion, whose rounding residue the MXU GEMM
// leaves; a self-pair comes out exactly 0.  With `itakura` the DP is the
// Itakura slope recursion (steps (1,0), (1,1), (1,2), no two (1,0) in a
// row) over the same valid cells.
//
// What bounds it on the H100: instruction issue and latency, not device
// memory.  An in-band cell costs F squared differences, two fp32
// instructions a feature (the subtraction and the FMA), which no
// rearrangement of the exact cost removes; one chunk reads ~11 MB of
// features.  The operands come from shared memory, which serves one 32-lane
// 4-byte load an SM a clock, a quarter of the fp32 issue rate: the previous
// design, which loaded one template value a (cell, feature) for every cell
// of the walked parallelogram (2.4-6x the band's cells), was bound by those
// loads.  The DP itself is a chain of ~la + lb dependent min/add steps a
// pair, each a shuffle's latency long, so the warps an SM holds (shared
// memory and 128 registers a thread) set how much of it is hidden.
//
// Design, after kernel 5 (csrc/dtw_wavefront.cu) and the microbenchmarks
// of csrc/mb_wavefront.cu:
// * One warp a pair; lanes own rows.  A pair runs in strips of 32 rows:
//   lane l owns row r0 + l and at step s works on column jlo + s - l, so
//   D(i-1, j) arrives from lane l-1 by one __shfl_up_sync and no block
//   barrier separates the steps.  The last row of a strip is handed to
//   lane 0 of the next through shared memory.
// * Only the band is walked.  Row i's valid columns form one interval
//   [lo(i), hi(i)] whose ends never decrease with i, so a strip walks
//   columns lo(r0) .. hi(last row), ~67 + 31 steps at T = U = 198, not
//   lb + 31.  kernels/dtw_fused_banded.py:strip_columns is the same rule
//   in Python, tested against the reference's valid-cell mask.
// * Only the band's costs are computed, in register tiles.  A strip's
//   cells are cut into tiles of 4 rows x 4 columns (tile row t: rows
//   r0 + 4t .. + 3; tile columns at jlo + 4k); of each tile row only the
//   tiles from its first row's lo to its last row's hi are computed, less
//   those that meet no row's interval (kernels/dtw_fused_banded.py:
//   cost_tiles states the rule): 1.1-1.5x the valid cells.  A feature's 4
//   query and 4 template values serve a tile's 16 cells (0.5 loads a cell
//   and feature), the strip's query rows staged in shared memory beside the
//   template, both at an odd row stride, so that distinct tile rows or
//   columns of 32 fall on distinct banks.  The 32 lanes take the tiles 32
//   at a time in one order (by block of 32 columns, tile row, column),
//   whatever row they own; a round of 16 or fewer tiles gives each tile 2
//   or 4 lanes, 2 rows or 1 each.
// * The costs reach the walk through a ring of two blocks of 32 columns a
//   row (block m in half (m + 1) % 2).  Chunk c of 32 steps reads columns
//   jlo + 32c - 31 .. jlo + 32c + 31, blocks c - 1 and c, so the warp
//   computes block c's tiles just before it; a step's 32 lanes read 32
//   distinct banks.  The walk itself is the previous design's.
// * A block stages one template (31 KB at U = 198) for up to 16 warps; its
//   warps take its queries one at a time (an atomic counter in shared
//   memory), so short and long queries even out.  The host takes the block
//   size that keeps most warps on an SM and up to 8 queries a warp where
//   the launch has pairs enough to keep every warp the card holds busy
//   (kernels/dtw_fused_banded.py:launch_plan, queries_a_block).
// * Long templates: where the whole template does not fit a one-warp block
//   (at F = 39, T = 198: U > 1,369 frames, U > 1,335 with Itakura), the
//   kernel runs in its window mode: the tiles read their template values
//   from device memory (the L1 and L2 caches) instead.  The edge row (NS *
//   u_pad floats a warp) is then what bounds U: at one warp, F = 39 and T
//   = 198, U up to 54,770 frames (27,372 with Itakura); beyond that the
//   launch fails and the wrapper raises.  Window mode's time is in PERF.md
//   (kernel 1, the `long` case of chip_smoke.py).

#include <cuda_runtime.h>
#include <math.h>

#include "warp_walk.cuh"

namespace {

constexpr float BIG = 1e30f;
constexpr int MAX_WARPS = 16;           // warps a block, each walking one pair at a time
constexpr int TILE = 32;                // rows per strip = steps per chunk = columns per block
constexpr int RING = 2 * TILE;          // cost columns a row keeps: two blocks
constexpr int CT = 4;                   // a cost tile: CT rows x CT columns
constexpr int TROWS = TILE / CT;        // tile rows a strip
constexpr int TCOLS = TILE / CT;        // tile columns a block
constexpr unsigned FULL = 0xffffffffu;

struct Pair {
  int la, lb, lam1, lbm1, r2, w, rb_shift;
  bool banded, windowed;
  const int* offs;  // [nb] window starts, when windowed

  // Valid columns [lo, hi] of row i (empty: lo > hi).  Both ends never
  // decrease with i.  Mirrors kernels/dtw_fused_banded.py:_row_columns.
  __device__ void row(int i, int& lo, int& hi) const {
    if (i >= la) { lo = 1; hi = 0; return; }
    lo = 0;
    hi = lb - 1;
    if (banded) {
      const int num = i * lbm1 - r2;
      if (num > 0) lo = (num + lam1 - 1) / lam1;
      hi = min(hi, (i * lbm1 + r2) / lam1);
    }
    if (windowed) {
      const int off = offs[i >> rb_shift];
      lo = max(lo, off);
      hi = min(hi, off + w - 1);
    }
  }
};

// Column c of the row above a strip (the previous strip's last row, held in
// `edge` for columns lo..hi; BIG elsewhere and above row 0).  The load is
// clamped in bounds and made by every lane, so no lane branches.
__device__ __forceinline__ float row_above(const float* edge, int c, int lo, int hi,
                                           int u_pad) {
  const float v = edge[min(max(c, 0), u_pad - 1)];
  return (c >= lo && c <= hi) ? v : BIG;
}

// Row stride of the staged query strip and template: odd, so that rows a
// tile (4) or a tile row (1) apart, up to 8 of them, fall on distinct banks.
__host__ __device__ __forceinline__ int feature_stride(int f_dim) { return f_dim | 1; }

// Tiles of a tile row in blocks before block m: the row's tiles are tile
// columns a .. a + n - 1.
__device__ __forceinline__ int tiles_before(int m, int a, int n) {
  return min(max(m * TCOLS - a, 0), n);
}

// Rows r0 .. r0 + 31 of a query (q: [t_pad][f_dim]; rows past t_pad - 1
// repeat it) into qs ([TILE][fs]).  With fs == f_dim the rows are one run
// of floats, and a lane issues all its loads (up to QB a batch) before it
// stores them, so their latencies overlap.
constexpr int QB = 40;                  // query loads a lane has in flight
__device__ __forceinline__ void stage_strip(float* qs, const float* __restrict__ q, int r0,
                                            int t_pad, int f_dim, int fs, int lane) {
  if (fs != f_dim) {
    walk::stage_rows(qs, q, r0, TILE, t_pad - 1, f_dim, fs, lane);
    return;
  }
  const int first = r0 * f_dim, last = t_pad * f_dim - 1;
  for (int i0 = 0; i0 < f_dim; i0 += QB) {
    float v[QB];
#pragma unroll
    for (int i = 0; i < QB; ++i)
      if (i0 + i < f_dim) v[i] = __ldg(q + min(first + (i0 + i) * 32 + lane, last));
#pragma unroll
    for (int i = 0; i < QB; ++i)
      if (i0 + i < f_dim) qs[(i0 + i) * 32 + lane] = v[i];
  }
}

// The costs of ROWS rows (query rows q, q + fs, ..; ring rows dst, dst +
// RING, ..) against template columns c0 .. c0 + 3 (rows of trows at stride
// ts, those past lb - 1 repeating it): a feature's ROWS + 4 loads serve
// its 4 ROWS cells.  Each cost sums (q - t)^2 over the features in order.
template <int ROWS, bool WINDOW>
__device__ __forceinline__ void tile_costs(const float* q, int fs, const float* trows, int ts,
                                           int c0, int lb, int f_dim, int squared,
                                           float* dst) {
  const float* tp[CT];
#pragma unroll
  for (int e = 0; e < CT; ++e) tp[e] = trows + (size_t)min(c0 + e, lb - 1) * ts;
  float acc[ROWS][CT];
#pragma unroll
  for (int a = 0; a < ROWS; ++a)
#pragma unroll
    for (int e = 0; e < CT; ++e) acc[a][e] = 0.f;
#pragma unroll 2
  for (int f = 0; f < f_dim; ++f) {
    float qv[ROWS], tv[CT];
#pragma unroll
    for (int a = 0; a < ROWS; ++a) qv[a] = q[a * fs + f];
#pragma unroll
    for (int e = 0; e < CT; ++e) tv[e] = WINDOW ? __ldg(tp[e] + f) : tp[e][f];
#pragma unroll
    for (int a = 0; a < ROWS; ++a)
#pragma unroll
      for (int e = 0; e < CT; ++e) {
        const float d = qv[a] - tv[e];
        acc[a][e] = fmaf(d, d, acc[a][e]);
      }
  }
#pragma unroll
  for (int a = 0; a < ROWS; ++a)
#pragma unroll
    for (int e = 0; e < CT; ++e) dst[a * RING + e] = squared ? acc[a][e] : sqrtf(acc[a][e]);
}

template <bool ITAKURA, bool WINDOW>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
dtw_banded_kernel(const float* __restrict__ queries, const int* __restrict__ q_lens,
                  const float* __restrict__ bank, const int* __restrict__ bank_lens,
                  float* __restrict__ out, int n_queries, int n_templates, int t_pad,
                  int u_pad, int f_dim, int w, int s_max, int rb, int banded,
                  int windowed, float band_frac, int squared, int per_block) {
  constexpr int NS = ITAKURA ? 2 : 1;   // DP states handed from strip to strip
  extern __shared__ float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = blockIdx.x;
  const int b_first = blockIdx.y * per_block;
  const int b_end = min(b_first + per_block, n_queries);
  const int fs = feature_stride(f_dim);
  const int nb = (t_pad + rb - 1) / rb;

  Pair g;
  g.lb = min(max(bank_lens[k], 1), u_pad);

  // stage the template once for the block's warps (window mode reads it
  // from device memory)
  float* tmpl = smem;                   // [u_pad][fs], none in window mode
  const float* bg = bank + (size_t)k * u_pad * f_dim;
  if (!WINDOW) {
    const int per = (g.lb + warps - 1) / warps;
    const int first = warp * per;
    walk::stage_rows(tmpl + (size_t)first * fs, bg, first, min(per, g.lb - first), g.lb - 1,
                     f_dim, fs, lane);
  }
  const size_t per_warp = TILE * RING + TILE * fs + NS * TILE + NS * u_pad + nb;
  // the block's next query, taken by the first free warp
  int* next_pair = reinterpret_cast<int*>(tmpl + (WINDOW ? 0 : (size_t)u_pad * fs) +
                                          warps * per_warp);
  if (threadIdx.x == 0) *next_pair = b_first;
  __syncthreads();

  float* ring = tmpl + (WINDOW ? 0 : (size_t)u_pad * fs) + warp * per_warp;  // [TILE][RING]
  float* qs = ring + TILE * RING;       // [TILE][fs] the strip's query rows
  float* stage = qs + TILE * fs;        // [NS][TILE] the last row's chunk
  float* edge = stage + NS * TILE;      // [NS][u_pad] D (and N) of row r0 - 1
  int* offs = reinterpret_cast<int*>(edge + NS * u_pad);  // [nb]
  const float* trows = WINDOW ? bg : tmpl;
  const int ts = WINDOW ? f_dim : fs;

  for (;;) {
    int b = 0;
    if (lane == 0) b = atomicAdd(next_pair, 1);
    b = __shfl_sync(FULL, b, 0);
    if (b >= b_end) break;                // whole warp: no block barrier follows
    g.la = min(max(q_lens[b], 1), t_pad);
    g.lam1 = max(g.la - 1, 1);
    g.lbm1 = g.lb - 1;
    g.banded = banded != 0;
    g.windowed = windowed != 0;
    g.w = w;
    g.rb_shift = __ffs(rb) - 1;           // rb is a power of two (plan_window: 16 or 32)
    g.offs = offs;
    g.r2 = 0;
    if (g.banded) {
      // f32 multiply + floor, as ops/dtw.py:band_r2 (no contraction, no fast math)
      const float radius = fmaxf(1.0f, __fmul_rn(band_frac, (float)max(g.la, g.lb)));
      g.r2 = (int)floorf(__fmul_rn(radius, (float)g.lam1));
    }
    if (g.windowed && lane == 0) {
      int prev = 0;
      const int clip8 = ((max(g.lb - w, 0) + 7) / 8) * 8;
      for (int blk = 0; blk < nb; ++blk) {
        const int num = max(blk * rb * g.lbm1 - g.r2, 0);
        const int jlo = (num + g.lam1 - 1) / g.lam1;
        int off = max((jlo / 8) * 8 - 8, 0);
        off = min(off, clip8);
        off = min(off, prev + s_max);
        offs[blk] = off;
        prev = off;
      }
    }
    __syncwarp();

    const float* qg = queries + (size_t)b * t_pad * f_dim;
    float result = BIG;
    int pjlo = 0, pjhi = -1;              // columns of row r0 - 1 in `edge` (none above row 0)
    for (int r0 = 0; r0 < g.la; r0 += TILE) {
      const int i = r0 + lane;
      const int r_last = min(r0 + TILE, g.la) - 1;
      int lo, hi, jlo, jhi, unused;
      g.row(i, lo, hi);
      g.row(r0, jlo, unused);
      g.row(r_last, unused, jhi);
      if (jhi < jlo) break;               // every row of the strip is empty: unreachable
      // the strip's query rows; the last strip's readers finished at its
      // closing __syncwarp
      stage_strip(qs, qg, r0, t_pad, f_dim, fs, lane);
      // tile row t = lane % 8 (rows r0 + 4t ..): tile columns ta .. ta + tn - 1
      // (relative to jlo), from its first row's lo to its last row's hi;
      // `gaps` where some tile row's rows leave a column between them that
      // none holds (then a tile in its range may meet no row)
      int ta, tn;
      bool gaps;
      {
        const int t = lane % TROWS;
        const int first = CT * t, last = min(CT * t + CT - 1, r_last - r0);
        const int flo = __shfl_sync(FULL, lo, first), lhi = __shfl_sync(FULL, hi, last);
        ta = (flo - jlo) / CT;
        tn = first <= r_last - r0 && flo <= lhi ? (lhi - jlo) / CT - ta + 1 : 0;
        bool gap = false;
        int reach = flo - 1;              // the last column the rows so far hold
#pragma unroll
        for (int a = 0; a < CT; ++a) {
          const int rlo = __shfl_sync(FULL, lo, min(first + a, last));
          const int rhi = __shfl_sync(FULL, hi, min(first + a, last));
          if (rlo <= rhi) {
            gap |= rlo > reach + 1;
            reach = max(reach, rhi);
          }
        }
        gaps = __any_sync(FULL, (gap || reach < lhi) && tn > 0);
      }
      __syncwarp();                       // qs's rows, for every lane
      int done = 0;                       // tiles computed, in the order above
      const int n_steps = (jhi - jlo + 1) + (r_last - r0);
      // DP state: D(i, j-1); the values this lane sent at the previous step;
      // D(i-1, j-1) and D(i-1, j-2), i.e. what it received one and two steps ago
      // (lane 0: the row above, read from `edge`)
      float left = BIG, last = BIG, last_n = BIG;
      float up1 = lane == 0 ? row_above(edge, jlo - 1, pjlo, pjhi, u_pad) : BIG;
      float up2 = lane == 0 ? row_above(edge, jlo - 2, pjlo, pjhi, u_pad) : BIG;
      const bool origin = lane == 0 && r0 == 0;  // lane 0 of row 0 starts from D(-1,-1) = 0
      for (int s0 = 0, c = 0; s0 < n_steps; s0 += TILE, ++c) {
        const int jc = jlo + s0 - lane;   // this lane's column at step s0
        const int n_here = min(TILE, n_steps - s0);
        // 1. the costs of block c, 32 tiles at a time, off the dependent
        // chain.  Lane t < 8 holds tile row t's tiles in the block: cnt of
        // them from tile column k0, flat indices from first (the block's
        // tiles come after those of blocks before it, done so far, and in
        // tile-row order)
        const int b0 = tiles_before(c, ta, tn);
        const int cnt = lane < TROWS ? tiles_before(c + 1, ta, tn) - b0 : 0;
        const int k0 = ta + b0;
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < TROWS; d <<= 1) {
          const int v = __shfl_up_sync(FULL, incl, d);
          if (lane >= d) incl += v;
        }
        const int first = lane < TROWS ? done + incl - cnt : 0x7fffffff;
        const int need = done + __shfl_sync(FULL, incl, TROWS - 1);
        while (done < need) {
          const int end = min(done + 32, need);
          // a round of few tiles splits each over 2 or 4 lanes, rows apart
          const int split = end - done <= TILE / 4 ? 4 : end - done <= TILE / 2 ? 2 : 1;
          const int x = done + lane / split;
          // the group of flat index x: the last whose first index is <= x
          int tt = 0;
#pragma unroll
          for (int step = TROWS / 2; step > 0; step >>= 1)
            if (__shfl_sync(FULL, first, tt + step) <= x) tt += step;
          const int kk = __shfl_sync(FULL, k0, tt) + x - __shfl_sync(FULL, first, tt);
          const int c0 = jlo + CT * kk;   // the tile's first column
          bool live = x < end;
          if (gaps) {
            bool meets = false;
#pragma unroll
            for (int a = 0; a < CT; ++a) {
              const int rlo = __shfl_sync(FULL, lo, CT * tt + a);
              const int rhi = __shfl_sync(FULL, hi, CT * tt + a);
              meets |= rlo <= rhi && rlo <= c0 + CT - 1 && rhi >= c0;
            }
            live &= meets;
          }
          if (live) {
            const int row = CT * tt + lane % split * (CT / split);  // this lane's first row
            const float* q = qs + row * fs;
            // block c lives in half (c + 1) % 2 of the ring
            float* dst = ring + row * RING + TILE * ((c + 1) % 2) + (CT * kk) % TILE;
            if (split == 1)
              tile_costs<CT, WINDOW>(q, fs, trows, ts, c0, g.lb, f_dim, squared, dst);
            else if (split == 2)
              tile_costs<CT / 2, WINDOW>(q, fs, trows, ts, c0, g.lb, f_dim, squared, dst);
            else
              tile_costs<CT / 4, WINDOW>(q, fs, trows, ts, c0, g.lb, f_dim, squared, dst);
          }
          done = end;
        }
        __syncwarp();
        // 2. the 32 dependent steps over the ring: at step s this lane reads
        // column jc + s, in block c - 1 while s < lane, else in block c
        const float* cost_lo = ring + lane * RING + TILE * (c % 2) + TILE - lane;
        const float* cost_hi = ring + lane * RING + TILE * ((c + 1) % 2) - lane;
#pragma unroll 4
        for (int s = 0; s < n_here; ++s) {
          const int j = jc + s;
          const bool ok = j >= lo && j <= hi;
          const float cv = (s < lane ? cost_lo : cost_hi)[s];
          const float up_e = row_above(edge, j, pjlo, pjhi, u_pad);
          float up = __shfl_up_sync(FULL, last, 1);      // D(i-1, j) from lane l-1
          if (lane == 0) up = up_e;
          const float d1 = (origin && j == 0) ? 0.f : up1;  // D(i-1, j-1)
          float val;
          if (!ITAKURA) {
            val = ok ? cv + fminf(left, fminf(up, d1)) : BIG;
            left = val;
            if (lane == TILE - 1) stage[s] = val;
          } else {
            const float up_ne = row_above(edge + u_pad, j, pjlo, pjhi, u_pad);
            float up_n = __shfl_up_sync(FULL, last_n, 1);  // N(i-1, j)
            if (lane == 0) up_n = up_ne;
            const float d2 = up2;                          // D(i-1, j-2)
            float nv = BIG;
            val = BIG;
            if (ok) {
              nv = cv + fminf(d1, d2);
              val = fminf(nv, cv + up_n);  // one (1,0) step after a non-(1,0) one
            }
            last_n = nv;
            if (lane == TILE - 1) {
              stage[s] = val;
              stage[TILE + s] = nv;
            }
          }
          if (i == g.la - 1 && j == g.lb - 1) result = val;
          up2 = up1;
          up1 = up;
          last = val;
        }
        // 3. hand the last row's chunk (columns jlo+s0-31 .. jlo+s0) to the
        // next strip; lane 0 of this strip reads only columns > jlo+s0 from
        // here on, so the overwrite is safe
        __syncwarp();
        const int col = jlo + s0 + lane - (TILE - 1);
        if (col >= 0 && col < u_pad) {
          edge[col] = stage[lane];
          if (ITAKURA) edge[u_pad + col] = stage[TILE + lane];
        }
        __syncwarp();
      }
      pjlo = jlo;
      pjhi = jhi;
    }
    // the lane that owns row la-1 holds the answer
    result = __shfl_sync(FULL, result, (g.la - 1) % TILE);
    if (lane == 0)
      out[(size_t)b * n_templates + k] = result / (float)(q_lens[b] + bank_lens[k]);
  }
}

// Mirrored by kernels/dtw_fused_banded.py:smem_bytes.
size_t dtw_banded_smem_bytes(int warps, int t_pad, int u_pad, int f_dim, int rb,
                             bool itakura, bool window) {
  const int ns = itakura ? 2 : 1;
  const size_t fs = feature_stride(f_dim);
  const size_t nb = (t_pad + rb - 1) / rb;
  const size_t per_warp = TILE * RING + TILE * fs + ns * TILE + (size_t)ns * u_pad + nb;
  // and the block's next query
  return sizeof(float) * ((window ? 0 : (size_t)u_pad * fs) + warps * per_warp + 1);
}

}  // namespace

// One launch in window mode or not, at `warps` warps a block taking
// `per_block` queries, as kernels/dtw_fused_banded.py:launch_plan and
// queries_a_block plan it.
extern "C" int dtw_banded(const void* queries, const void* q_lens, const void* bank,
                          const void* bank_lens, void* out, int n_queries,
                          int n_templates, int t_pad, int u_pad, int f_dim, int w,
                          int s_max, int rb, int banded, int windowed,
                          float band_frac, int squared, int itakura, int window,
                          int warps, int per_block, void* stream) {
  if (rb <= 0 || (rb & (rb - 1)) != 0 || t_pad < 1 || u_pad < 1 || f_dim < 1 ||
      warps < 1 || warps > MAX_WARPS || per_block < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      dtw_banded_smem_bytes(warps, t_pad, u_pad, f_dim, rb, itakura, window != 0);
  auto kernel = itakura ? (window ? dtw_banded_kernel<true, true> : dtw_banded_kernel<true, false>)
                        : (window ? dtw_banded_kernel<false, true> : dtw_banded_kernel<false, false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so it cannot surface at the next launch
    return (int)err;
  }
  dim3 grid(n_templates, (n_queries + per_block - 1) / per_block);
  kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)queries, (const int*)q_lens, (const float*)bank,
      (const int*)bank_lens, (float*)out, n_queries, n_templates, t_pad, u_pad, f_dim,
      w, s_max, rb, banded, windowed, band_frac, squared, per_block);
  return (int)cudaGetLastError();
}
