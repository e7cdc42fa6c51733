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
// The local cost is the exact sqrt(sum (a-b)^2) in fp32 (its square with
// `squared`), not the TPU's |a|^2 + |b|^2 - 2ab expansion, whose rounding
// residue the MXU GEMM leaves; a self-pair comes out exactly 0.  With
// `itakura` the DP is the Itakura slope recursion (steps (1,0), (1,1),
// (1,2), no two (1,0) in a row) over the same valid cells.
//
// What bounds it on the H100: instruction issue and the shared-memory load
// rate, not device memory.  At the main-path shape (256 queries x 100
// templates, T = U = 198, F = 39, band 0.17) the in-band cells cost 39
// squared differences each (about 0.16 ms of fp32 work over the card),
// while one chunk reads ~11 MB of features.  The DP itself is a chain of
// ~la + lb dependent min/add steps a pair.  The first design (one block a
// pair, the cells of an anti-diagonal shared by 256 threads, a block
// barrier between diagonals) spent ~7 of its 10.8 ms in that per-diagonal
// skeleton: ~395 barrier-separated steps a pair with ~34 cells each.
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
//   columns lo(r0) .. hi(last row), ~67 + 31 steps at the main shape, not
//   lb + 31.  kernels/dtw_fused_banded.py:strip_columns is the same rule
//   in Python, tested against the reference's valid-cell mask.
// * The cost is out of the dependent chain.  For each chunk of 32 steps
//   every lane first computes its row's 32 costs (independent FMAs, eight
//   at a time) into a 32 x 33 shared tile, then the 32 dependent steps run
//   over the tile: one shuffle, two mins and an add a step.  The query row
//   stays in the lane's registers for the whole strip (F <= 40; wider
//   features are summed 40 at a time into the tile); template rows come
//   from shared memory at an odd row stride, so the 32 lanes, on 32
//   consecutive template rows, hit 32 banks.
// * A block holds up to 8 warps = 8 queries against one template, which
//   is staged once (31 KB at U = 198); query rows come from device memory
//   (a chunk's features sit in L2).  The host takes fewer warps a block
//   where shared memory or the batch is short.
// * Long templates: where the whole template does not fit a one-warp block
//   (at F = 39, T = 198: U > 1,357 frames, U > 1,325 with Itakura), the
//   kernel runs in its window mode instead.  A chunk of 32 steps over 32
//   lanes reads template rows jlo + s0 - 31 .. jlo + s0 + 31 (clamped to
//   [0, lb-1]); each warp stages those 63 rows into a window of its own
//   (10.3 KB at F = 39, same odd stride) before the chunk's costs, and the
//   cost loop reads slot 31 - lane + step.  The edge row (NS * u_pad floats
//   a warp) is then what bounds U: at one warp, F = 39 and T = 198, U up to
//   54,428 frames (27,201 with Itakura); beyond that the launch fails and
//   the wrapper raises.  kernels/dtw_fused_banded.py:launch_plan states the
//   host's rule in Python.  Window mode's time is in PERF.md (kernel 1,
//   the `long` case of chip_smoke.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int MAX_WARPS = 8;            // pairs per block, one warp each
constexpr int TILE = 32;                // rows per strip = steps per cost chunk
constexpr int TS = TILE + 1;            // tile row stride
constexpr int QF = 40;                  // query features held in registers
constexpr int G = 8;                    // costs summed side by side
constexpr int WIN = 2 * TILE - 1;       // template rows a chunk reads (window mode)
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

// Template row stride: the features rounded up to whole blocks of QF (zero
// filled, so the cost loop needs no bound) and odd, so that 32 lanes on 32
// consecutive rows fall on 32 banks.
__host__ __device__ __forceinline__ int feature_stride(int f_dim) {
  return (((f_dim + QF - 1) / QF) * QF) | 1;
}

template <bool ITAKURA, bool WINDOW>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
dtw_banded_kernel(const float* __restrict__ queries, const int* __restrict__ q_lens,
                  const float* __restrict__ bank, const int* __restrict__ bank_lens,
                  float* __restrict__ out, int n_queries, int n_templates, int t_pad,
                  int u_pad, int f_dim, int w, int s_max, int rb, int banded,
                  int windowed, float band_frac, int squared) {
  constexpr int NS = ITAKURA ? 2 : 1;   // DP states handed from strip to strip
  extern __shared__ float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = blockIdx.x;
  const int b = blockIdx.y * warps + warp;
  const int fs = feature_stride(f_dim);
  const int nb = (t_pad + rb - 1) / rb;

  Pair g;
  g.lb = min(max(bank_lens[k], 1), u_pad);

  // stage the template once for the block's warps, zero past f_dim (in
  // window mode each warp stages the rows of a chunk instead)
  float* tmpl = smem;                   // [u_pad][fs], none in window mode
  const float* bg = bank + (size_t)k * u_pad * f_dim;
  if (!WINDOW) {
    for (int idx = threadIdx.x; idx < g.lb * fs; idx += blockDim.x) {
      const int r = idx / fs, f = idx - r * fs;
      tmpl[idx] = f < f_dim ? bg[r * f_dim + f] : 0.f;
    }
    __syncthreads();
  }
  if (b >= n_queries) return;           // whole warp: no block barrier follows

  const size_t per_warp = TILE * TS + NS * TILE + NS * u_pad + nb + (WINDOW ? WIN * fs : 0);
  float* tile = tmpl + (WINDOW ? 0 : (size_t)u_pad * fs) + warp * per_warp;  // [TILE][TS]
  float* stage = tile + TILE * TS;      // [NS][TILE] the last row's chunk
  float* edge = stage + NS * TILE;      // [NS][u_pad] D (and N) of row r0 - 1
  int* offs = reinterpret_cast<int*>(edge + NS * u_pad);  // [nb]
  float* win = edge + NS * u_pad + nb;  // [WIN][fs] window mode: template rows of a chunk

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
    const float* qrow = qg + (size_t)min(i, g.la - 1) * f_dim;
    float q[QF];
    if (f_dim <= QF) {
#pragma unroll
      for (int f = 0; f < QF; ++f) q[f] = f < f_dim ? qrow[f] : 0.f;
    }
    const int n_steps = (jhi - jlo + 1) + (r_last - r0);
    // DP state: D(i, j-1); the values this lane sent at the previous step;
    // D(i-1, j-1) and D(i-1, j-2), i.e. what it received one and two steps ago
    // (lane 0: the row above, read from `edge`)
    float left = BIG, last = BIG, last_n = BIG;
    float up1 = lane == 0 ? row_above(edge, jlo - 1, pjlo, pjhi, u_pad) : BIG;
    float up2 = lane == 0 ? row_above(edge, jlo - 2, pjlo, pjhi, u_pad) : BIG;
    const bool origin = lane == 0 && r0 == 0;  // lane 0 of row 0 starts from D(-1,-1) = 0
    for (int s0 = 0; s0 < n_steps; s0 += TILE) {
      const int jc = jlo + s0 - lane;   // this lane's column at step s0
      const int n_here = min(TILE, n_steps - s0);
      if (WINDOW) {
        // 0. template rows jlo+s0-31 .. jlo+s0+31, clamped to [0, lb-1]: slot
        // x holds the row lane l reads at step s for x = 31 - l + s (the
        // previous chunk's reads ended at its closing __syncwarp)
        const int base = jlo + s0 - (TILE - 1);
        for (int x = 0; x < WIN; ++x) {
          const float* src = bg + (size_t)min(max(base + x, 0), g.lb - 1) * f_dim;
          for (int f = lane; f < fs; f += 32) win[x * fs + f] = f < f_dim ? src[f] : 0.f;
        }
        __syncwarp();
      }
      // 1. this lane's 32 costs of the chunk, off the dependent chain
      for (int fb = 0; fb < f_dim; fb += QF) {
        if (f_dim > QF) {
#pragma unroll
          for (int f = 0; f < QF; ++f) q[f] = fb + f < f_dim ? qrow[fb + f] : 0.f;
        }
        const bool last_block = fb + QF >= f_dim;
        for (int s = 0; s < n_here; s += G) {
          float acc[G];
          int at[G];
#pragma unroll
          for (int e = 0; e < G; ++e) {
            at[e] = (WINDOW ? TILE - 1 - lane + s + e : min(max(jc + s + e, 0), g.lb - 1)) * fs + fb;
            acc[e] = fb == 0 ? 0.f : tile[lane * TS + s + e];
          }
          // features past f_dim are 0 in both q and the template: d = 0 adds 0
          const float* rows = WINDOW ? win : tmpl;
#pragma unroll
          for (int f = 0; f < QF; ++f) {
#pragma unroll
            for (int e = 0; e < G; ++e) {
              const float d = q[f] - rows[at[e] + f];
              acc[e] = fmaf(d, d, acc[e]);
            }
          }
#pragma unroll
          for (int e = 0; e < G; ++e)
            tile[lane * TS + s + e] = (last_block && !squared) ? sqrtf(acc[e]) : acc[e];
        }
      }
      // 2. the 32 dependent steps over the tile
#pragma unroll 8
      for (int s = 0; s < n_here; ++s) {
        const int j = jc + s;
        const bool ok = j >= lo && j <= hi;
        const float c = tile[lane * TS + s];
        const float up_e = row_above(edge, j, pjlo, pjhi, u_pad);
        float up = __shfl_up_sync(FULL, last, 1);      // D(i-1, j) from lane l-1
        if (lane == 0) up = up_e;
        const float d1 = (origin && j == 0) ? 0.f : up1;  // D(i-1, j-1)
        float val;
        if (!ITAKURA) {
          val = ok ? c + fminf(left, fminf(up, d1)) : BIG;
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
            nv = c + fminf(d1, d2);
            val = fminf(nv, c + up_n);   // one (1,0) step after a non-(1,0) one
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

// Mirrored by kernels/dtw_fused_banded.py:smem_bytes.
size_t dtw_banded_smem_bytes(int warps, int t_pad, int u_pad, int f_dim, int rb,
                             bool itakura, bool window) {
  const int ns = itakura ? 2 : 1;
  const size_t fs = feature_stride(f_dim);
  const size_t nb = (t_pad + rb - 1) / rb;
  const size_t per_warp =
      TILE * TS + ns * TILE + (size_t)ns * u_pad + nb + (window ? WIN * fs : 0);
  return sizeof(float) * ((window ? 0 : (size_t)u_pad * fs) + warps * per_warp);
}

}  // namespace

extern "C" int dtw_banded(const void* queries, const void* q_lens, const void* bank,
                          const void* bank_lens, void* out, int n_queries,
                          int n_templates, int t_pad, int u_pad, int f_dim, int w,
                          int s_max, int rb, int banded, int windowed,
                          float band_frac, int squared, int itakura, void* stream) {
  if (rb <= 0 || (rb & (rb - 1)) != 0 || t_pad < 1 || u_pad < 1 || f_dim < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // fewest idle warps for short batches; window mode where the whole template
  // does not fit a one-warp block; fewer warps where shared memory is short
  // (kernels/dtw_fused_banded.py:launch_plan is the same rule)
  int warps = MAX_WARPS;
  while (warps > 1 && warps / 2 >= n_queries) warps /= 2;
  const bool window =
      dtw_banded_smem_bytes(1, t_pad, u_pad, f_dim, rb, itakura, false) > (size_t)optin;
  while (warps > 1 &&
         dtw_banded_smem_bytes(warps, t_pad, u_pad, f_dim, rb, itakura, window) > (size_t)optin)
    warps /= 2;
  const size_t smem = dtw_banded_smem_bytes(warps, t_pad, u_pad, f_dim, rb, itakura, window);
  auto kernel = itakura ? (window ? dtw_banded_kernel<true, true> : dtw_banded_kernel<true, false>)
                        : (window ? dtw_banded_kernel<false, true> : dtw_banded_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so it cannot surface at the next launch
    return (int)err;
  }
  dim3 grid(n_templates, (n_queries + warps - 1) / warps);
  kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)queries, (const int*)q_lens, (const float*)bank,
      (const int*)bank_lens, (float*)out, n_queries, n_templates, t_pad, u_pad, f_dim,
      w, s_max, rb, banded, windowed, band_frac, squared);
  return (int)cudaGetLastError();
}
