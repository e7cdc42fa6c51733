// All-pairs windowed Sakoe-Chiba DTW, one thread block per (query, template).
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
// The TPU kernel's lane rolls, 128-lane window extraction, prefix-summed
// closed-form row DP and revolving output block are not carried over.
// Here each block stages the two feature matrices in shared memory and
// computes every valid cell's cost directly as sum((a-b)^2) in fp32
// (sqrt unless `squared`).  Standard DTW walks anti-diagonals: the cells
// of one diagonal are independent, so the block's threads share them,
// with three rolling diagonal buffers and one barrier per diagonal.  The
// Itakura DP (every step advances the query row) walks rows instead, with
// two rolling rows of its two states.
//
// What bounds it on the H100: latency and the shared-memory load rate,
// not device memory.  At the main-path shape (T = U = 198, F = 39, band
// 0.17) a pair has about 13.5k in-band cells x 39 FMAs with two shared
// loads each, spread over ~400 dependent diagonal steps, while a chunk of
// 256 queries x 100 templates reads only ~11 MB of features.  The design
// keeps all per-pair traffic in shared memory and touches only the in-band
// cells of each diagonal (about 34 at this shape).  Each cell gets SUB
// threads that sum strided slices of the features and combine them with
// warp shuffles, so one diagonal step is ~F/SUB dependent loads deep and a
// 256-thread block covers 64 cells per pass.  Occupancy is bounded by the
// ~65 KB of staged features per block: three blocks, 24 warps, per SM.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int SUB = 4;                  // threads per cell
constexpr int THREADS = 256;
constexpr int CELLS = THREADS / SUB;    // cells per pass

struct PairGeometry {
  int la, lb, lam1, lbm1, r2;
  bool banded, windowed;
  int w, rb_shift;
  const int* offs;  // [nb] window starts (shared memory), when windowed

  __device__ bool valid(int i, int j) const {
    if (i < 0 || j < 0 || i >= la || j >= lb) return false;
    if (banded && abs(j * lam1 - i * lbm1) > r2) return false;
    if (windowed) {
      int off = offs[i >> rb_shift];
      if (j < off || j >= off + w) return false;
    }
    return true;
  }
};

// Squared distance of feature rows a and b, summed by the SUB threads of a
// cell group (lanes sub = 0..SUB-1 of one warp); every lane gets the sum.
// All lanes of the warp must call it.
// The first UNROLL slices are unrolled so their loads issue back to back.
constexpr int UNROLL = 10;              // covers F <= 40 (F = 39 on the main path)

__device__ __forceinline__ float group_sq_dist(const float* a, const float* b,
                                               int f_dim, int sub, bool active) {
  float s = 0.f;
  if (active) {
#pragma unroll
    for (int m = 0; m < UNROLL; ++m) {
      int f = sub + m * SUB;
      if (f < f_dim) {
        float d = a[f] - b[f];
        s = fmaf(d, d, s);
      }
    }
    for (int f = sub + UNROLL * SUB; f < f_dim; f += SUB) {
      float d = a[f] - b[f];
      s = fmaf(d, d, s);
    }
  }
#pragma unroll
  for (int o = 1; o < SUB; o *= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <bool ITAKURA>
__global__ void __launch_bounds__(THREADS)
dtw_banded_kernel(const float* __restrict__ queries, const int* __restrict__ q_lens,
                  const float* __restrict__ bank, const int* __restrict__ bank_lens,
                  float* __restrict__ out, int n_templates, int t_pad, int u_pad,
                  int f_dim, int w, int s_max, int rb, int banded, int windowed,
                  float band_frac, int squared) {
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int sub = tid % SUB;
  const int cell = tid / SUB;
  const int fs = f_dim | 1;  // odd row stride: rows fall on other banks
  const int nb = (t_pad + rb - 1) / rb;

  float* q_s = smem;                       // [t_pad, fs]
  float* b_s = q_s + t_pad * fs;           // [u_pad, fs]
  int* offs = reinterpret_cast<int*>(b_s + u_pad * fs);  // [nb]
  float* bufs = reinterpret_cast<float*>(offs + nb);

  PairGeometry g;
  g.la = max(q_lens[b], 1);
  g.lb = max(bank_lens[k], 1);
  g.lam1 = max(g.la - 1, 1);
  g.lbm1 = g.lb - 1;
  g.banded = banded != 0;
  g.windowed = windowed != 0;
  g.w = w;
  g.rb_shift = __ffs(rb) - 1;  // rb is a power of two (plan_window: 16 or 32)
  g.offs = offs;
  g.r2 = 0;
  if (g.banded) {
    // f32 multiply + floor, as ops/dtw.py:band_r2 (no contraction, no fast math)
    float radius = fmaxf(1.0f, __fmul_rn(band_frac, (float)max(g.la, g.lb)));
    g.r2 = (int)floorf(__fmul_rn(radius, (float)g.lam1));
  }

  const float* qg = queries + (size_t)b * t_pad * f_dim;
  const float* bg = bank + (size_t)k * u_pad * f_dim;
  const int warp = tid / 32, lane = tid % 32, n_warps = THREADS / 32;
  for (int r = warp; r < g.la; r += n_warps)
    for (int f = lane; f < f_dim; f += 32) q_s[r * fs + f] = qg[r * f_dim + f];
  for (int r = warp; r < g.lb; r += n_warps)
    for (int f = lane; f < f_dim; f += 32) b_s[r * fs + f] = bg[r * f_dim + f];
  if (g.windowed && tid == 0) {
    int prev = 0;
    int clip8 = ((max(g.lb - w, 0) + 7) / 8) * 8;
    for (int blk = 0; blk < nb; ++blk) {
      int num = max(blk * rb * g.lbm1 - g.r2, 0);
      int jlo = (num + g.lam1 - 1) / g.lam1;
      int off = max((jlo / 8) * 8 - 8, 0);
      off = min(off, clip8);
      off = min(off, prev + s_max);
      offs[blk] = off;
      prev = off;
    }
  }

  float dist;
  if (!ITAKURA) {
    // three diagonal buffers indexed by row i + 1 (index 0 is row -1)
    const int len = t_pad + 2;
    for (int idx = tid; idx < 3 * len; idx += THREADS) bufs[idx] = BIG;
    __syncthreads();
    // Rows of diagonal d inside the band: i*span in [d*lam1 - r2, d*lam1 + r2].
    // Both ends grow by lam1 <= span per diagonal, so the bounds
    // blo = ceil(max(num_lo, 0) / span) and bhi = floor(num_hi / span)
    // advance by at most one row each step: no division in the loop.
    const int span = g.lam1 + g.lbm1;
    const int last = g.la + g.lb - 2;
    int num_lo = -g.r2, num_hi = g.r2, blo = 0, bhi = g.r2 / span;
    for (int d = 0; d <= last; ++d) {
      int lo = max(0, d - g.lbm1);
      int hi = min(g.la - 1, d);
      if (g.banded) {
        if (blo * span < num_lo) ++blo;
        if ((bhi + 1) * span <= num_hi) ++bhi;
        lo = max(lo, blo);
        hi = min(hi, bhi);
        num_lo += g.lam1;
        num_hi += g.lam1;
      }
      float* cur = bufs + (d % 3) * len;
      const float* p1 = bufs + ((d + 2) % 3) * len;  // diagonal d-1
      const float* p2 = bufs + ((d + 1) % 3) * len;  // diagonal d-2
      // also rewrite one row either side: the next two diagonals read there
      for (int base = lo - 1; base <= hi + 1; base += CELLS) {  // block-uniform
        int i = base + cell;
        int j = d - i;
        bool in = i <= hi + 1;
        bool ok = in && i >= lo && i <= hi && g.valid(i, j);
        float sq = group_sq_dist(q_s + i * fs, b_s + j * fs, f_dim, sub, ok);
        if (sub == 0 && in) {
          float val = BIG;
          if (ok) {
            float pred = (d == 0) ? 0.f : fminf(fminf(p1[i], p1[i + 1]), p2[i]);
            val = (squared ? sq : sqrtf(sq)) + pred;
          }
          cur[i + 1] = val;
        }
      }
      __syncthreads();
    }
    dist = bufs[(last % 3) * len + g.la];
  } else {
    // two rows of the D and N states, indexed by column j + 2
    const int len = u_pad + 2;
    float* d_prev = bufs;
    float* n_prev = bufs + len;
    float* d_cur = bufs + 2 * len;
    float* n_cur = bufs + 3 * len;
    for (int idx = tid; idx < 4 * len; idx += THREADS) bufs[idx] = BIG;
    __syncthreads();
    for (int i = 0; i < g.la; ++i) {
      for (int base = 0; base < g.lb; base += CELLS) {  // block-uniform
        int j = base + cell;
        bool in = j < g.lb;
        bool ok = in && g.valid(i, j);
        float sq = group_sq_dist(q_s + i * fs, b_s + j * fs, f_dim, sub, ok);
        if (sub == 0 && in) {
          float nv = BIG, dv = BIG;
          if (ok) {
            float c = squared ? sq : sqrtf(sq);
            float s1 = (i == 0 && j == 0) ? 0.f : d_prev[j + 1];  // D(i-1, j-1)
            float s2 = d_prev[j];                                 // D(i-1, j-2)
            nv = c + fminf(s1, s2);
            dv = fminf(nv, c + n_prev[j + 2]);  // (1,0) after a non-(1,0) step
          }
          d_cur[j + 2] = dv;
          n_cur[j + 2] = nv;
        }
      }
      __syncthreads();
      float* t0 = d_prev; d_prev = d_cur; d_cur = t0;
      float* t1 = n_prev; n_prev = n_cur; n_cur = t1;
    }
    dist = d_prev[g.lb + 1];
  }
  if (tid == 0) {
    if (!g.valid(g.la - 1, g.lb - 1)) dist = BIG;  // answer cell outside the window
    out[(size_t)b * n_templates + k] = dist / (float)(q_lens[b] + bank_lens[k]);
  }
}

size_t dtw_banded_smem_bytes(int t_pad, int u_pad, int f_dim, int rb) {
  int fs = f_dim | 1;
  int nb = (t_pad + rb - 1) / rb;
  int bufs = max(3 * (t_pad + 2), 4 * (u_pad + 2));
  return sizeof(float) * ((size_t)(t_pad + u_pad) * fs + bufs) + sizeof(int) * nb;
}

}  // namespace

extern "C" int dtw_banded(const void* queries, const void* q_lens, const void* bank,
                          const void* bank_lens, void* out, int n_queries,
                          int n_templates, int t_pad, int u_pad, int f_dim, int w,
                          int s_max, int rb, int banded, int windowed,
                          float band_frac, int squared, int itakura, void* stream) {
  if (rb <= 0 || (rb & (rb - 1)) != 0) return (int)cudaErrorInvalidValue;
  size_t smem = dtw_banded_smem_bytes(t_pad, u_pad, f_dim, rb);
  auto kernel = itakura ? dtw_banded_kernel<true> : dtw_banded_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_templates, n_queries);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)queries, (const int*)q_lens, (const float*)bank,
      (const int*)bank_lens, (float*)out, n_templates, t_pad, u_pad, f_dim, w,
      s_max, rb, banded, windowed, band_frac, squared);
  return (int)cudaGetLastError();
}
