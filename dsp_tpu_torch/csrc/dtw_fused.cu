// Unbanded all-pairs DTW from features, one warp per (query, template)
// pair; the cost never reaches device memory.
//
// Replaces the TPU kernel dsp_tpu/kernels/dtw_fused.py (dtw_batch_fused /
// _fused_kernel): queries [B,T,F] x bank [K,U,F] -> distances [B,K] =
// D(la-1, lb-1) / (q_len + bank_len), unbanded, steps {(1,0),(0,1),(1,1)},
// over the expanded cost
//
//   c(i,j) = sqrt(max((|a_i|^2 + |b_j|^2) - 2 a_i.b_j, 0))   (or its square),
//
// rounded as the plain version rounds it (no contraction).  The DP is the
// direct min-plus recurrence D(i,j) = c + min(D(i,j-1), D(i-1,j), D(i-1,j-1))
// with D(-1,-1) = 0, cell by cell.  The TPU kernel's prefix-sum closed form
// (which the plain version, kernels/dtw_fused.py:dtw_batch_fused_plain,
// keeps) vectorises a row over 128 lanes; here it would cost two block-wide
// scans a row, and the two agree to rtol 1e-4 / atol 1e-5
// (tests/test_pallas_dtw.py:103) anyway.
//
// What bounds it on the H100: operations.  Each cell inside the lengths
// costs an F-long dot product (2F flops) and the DP's add and two mins; a
// chunk of 256 queries x 100 templates reads ~12 MB of features.  The first
// design (one block a pair, thread j on column j, a block prefix sum and a
// block prefix min a query row with two block barriers, every column up to
// round_up(U, 32) stepped) took 15.5x its bound and refused templates past
// 1,024 frames and queries whose features did not fit shared memory.
//
// Design (the walk of kernel 5, csrc/dtw_wavefront.cu, over costs computed
// in place; the pieces shared with kernel 3 are in csrc/warp_walk.cuh):
// * One warp a pair; lane l owns query row r0 + l of a strip of 32 rows.
//   At step s the lane is on column s - l, so D(i-1, j) arrives from lane
//   l-1 by one __shfl_sync and no block barrier separates the steps.  A
//   strip walks lb + rows - 1 steps.
// * The costs are off the dependent chain.  The lane holds its query row in
//   registers (40 features at a time; wider features are summed 40 at a
//   time) with |a|^2.  At the start of each chunk of 32 steps, t0 = 32m
//   (t0 < lb), it computes its row's costs against template columns t0 ..
//   t0 + 31 (those < lb, eight at a time, eight independent FMA chains),
//   reading each template frame as float4 broadcasts.  The chunk's steps
//   read columns t0 - 31 .. t0 + 31, so a 64-column ring (swizzled, free of
//   bank conflicts) holds this block and the one before.  A strip computes
//   32 x round_up(lb, 8) costs.  Lane 0's row above reaches it through the
//   step's shuffle, sent by lane 31 in place of its own value, so its
//   broadcast load stays off the dependent chain.
// * A block holds up to 8 warps, 8 queries against one template, which is
//   staged once with its |b_j|^2 (36 KB at U = 198, F = 39).  Where the
//   whole template does not fit a one-warp block (at F = 39 past 1,312
//   frames), each warp stages the 32 template frames of a chunk itself
//   (window mode) before computing their costs.
// * The last row of a strip reaches the next strip through `edge`, a row
//   of lb + 64 floats a warp in shared memory (BIG past lb - 1 and above
//   row 0): lane 31 stages a chunk's values and the warp copies them after
//   the chunk's __syncwarp, at columns the strip never reads again.  In
//   window mode the row is in device memory (`scratch`, one of u_pad floats
//   a pair) and each chunk copies its 32 columns to shared memory first, so
//   no length is bounded by shared memory: any query, template and feature
//   width runs.  Four __syncwarp a chunk (five in window mode), none a step.
// * On an NVIDIA H100 80GB HBM3 at 700 W this takes 2.44 ms at the main
//   path's shape (5.71 ms the first design; PERF.md, kernel 4).
// * kernels/dtw_fused.py states the walk (strips, cost_cells), the launch
//   (launch_plan) and window mode's query slices (window_rows) in Python.

#include "warp_walk.cuh"

namespace {

using walk::BIG;
using walk::FULL;
using walk::RING;
using walk::TILE;
using walk::round_up;
using walk::feature_stride;

constexpr int MAX_WARPS = 8;            // pairs per block, one warp each
constexpr int PAD = 64;                 // BIG past the edge row's lb columns

// Floats of one warp's region: the window of 32 template frames and their
// |b|^2 (window mode), the cost ring, the staged last row, the edge row
// (window mode: the chunk's 32 columns of it; the row itself is in device
// memory).
__host__ __device__ __forceinline__ size_t warp_floats(int u_pad, int fs, bool window) {
  return (window ? (size_t)TILE * fs + TILE : 0) + RING * TILE + TILE +
         (window ? TILE : round_up(u_pad + PAD, 4));
}

// Shared bytes of a block; mirrored by kernels/dtw_fused.py:smem_bytes.
size_t smem_bytes(int warps, int u_pad, int f_dim, bool window) {
  const int fs = feature_stride(f_dim);
  const size_t rows = round_up(u_pad, TILE);
  const size_t staged = window ? 0 : rows * fs + rows;
  return sizeof(float) * (staged + warps * warp_floats(u_pad, fs, window));
}

// The DP state a lane carries from step to step.
struct Lane {
  float left;     // D(i, j-1)
  float last;     // this lane's value at the previous step
  float up_prev;  // D(i-1, j-1): the value above at the previous step
  float result;   // D(la-1, lb-1), in the lane that owns row la-1
};

// Steps t0 .. t0 + n - 1 of a strip: lane l on column j = t0 + s - l, its
// cost at tile[tile_at(j, lane)].  Lane 0 takes the row above from `above`
// (above[s]: column t0 + s), the others from lane l-1.  FULL_CHUNK: all 32
// steps.
template <bool FULL_CHUNK>
__device__ __forceinline__ void steps(Lane& st, const float* __restrict__ tile,
                                      const float* __restrict__ above, float* __restrict__ stage,
                                      int lane, int t0, int n, int lb, bool row_ok, int j_end) {
#pragma unroll
  for (int s = 0; s < TILE; ++s) {
    if (!FULL_CHUNK && s >= n) break;
    const int j = t0 + s - lane;
    const float cv = tile[walk::tile_at(j, lane)];
    // D(i-1, j) from lane l-1; lane 0's from the row above, which lane 31
    // (whose own value only the next strip reads) sends in its place: the
    // broadcast load stays off the dependent chain
    const float up = __shfl_sync(FULL, lane == TILE - 1 ? above[s] : st.last, (lane - 1) & 31);
    const bool ok = row_ok && (unsigned)j < (unsigned)lb;
    const float val = ok ? cv + fminf(st.left, fminf(up, st.up_prev)) : BIG;
    if (lane == TILE - 1) stage[s] = val;
    if (j == j_end) st.result = val;
    st.left = val;
    st.up_prev = up;
    st.last = val;
  }
}

template <bool WINDOW>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
dtw_fused_kernel(const float* __restrict__ queries, const int* __restrict__ q_lens,
                 const float* __restrict__ bank, const int* __restrict__ bank_lens,
                 float* __restrict__ out, float* __restrict__ scratch, int n_queries,
                 int n_templates, int t_pad, int u_pad, int f_dim, int squared) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = blockIdx.x;
  const int b = blockIdx.y * warps + warp;
  const int fs = feature_stride(f_dim);
  const int lb = min(max(bank_lens[k], 1), u_pad);
  const int rows = round_up(u_pad, TILE);
  const float* bg = bank + (size_t)k * u_pad * f_dim;

  // stage the template once for the block's warps, with |b_j|^2, up to a
  // whole cost block (rows past lb repeat row lb-1; their costs are never
  // used); in window mode each warp stages a chunk's frames instead
  float* tmpl = smem;                                   // [rows][fs]
  float* sqb = tmpl + (size_t)rows * fs;                // [rows]
  if (!WINDOW) {
    const int n = round_up(lb, TILE);
    const int per = (n + warps - 1) / warps;            // rows a warp stages
    const int lo = min(n, warp * per);
    walk::stage_rows(tmpl + (size_t)lo * fs, bg, lo, min(n, lo + per) - lo, lb - 1, f_dim, fs,
                     lane);
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += blockDim.x) sqb[r] = walk::row_sq(tmpl + (size_t)r * fs, fs);
    __syncthreads();
  }
  if (b >= n_queries) return;           // whole warp: no block barrier follows

  float* win = smem + (WINDOW ? 0 : (size_t)rows * fs + rows) +
               warp * warp_floats(u_pad, fs, WINDOW);   // [TILE][fs], window mode
  float* wsq = win + (WINDOW ? TILE * fs : 0);          // [TILE]
  float* tile = wsq + (WINDOW ? TILE : 0);              // [RING][TILE] the lanes' costs
  float* stage = tile + RING * TILE;                    // [TILE] the last row's chunk
  // D of row r0 - 1: staged mode [lb + PAD] here, BIG above row 0 and past
  // column lb-1; window mode [u_pad] in device memory, its chunk of 32
  // columns copied here (BIG where above row 0 or past lb-1)
  float* edge = stage + TILE;
  float* gedge = scratch + ((size_t)b * n_templates + k) * u_pad;

  const int la = min(max(q_lens[b], 1), t_pad);
  if (!WINDOW)
    for (int x = lane; x < lb + PAD; x += 32) edge[x] = BIG;

  const float* qg = queries + (size_t)b * t_pad * f_dim;
  float result = BIG;
  for (int r0 = 0; r0 < la; r0 += TILE) {
    const int i = r0 + lane;
    const int n_rows = min(TILE, la - r0);
    const int n_steps = lb + n_rows - 1;
    const bool row_ok = i < la;
    const int j_end = i == la - 1 ? lb - 1 : -1;
    // the lane's query row (rows past la-1 repeat it) in registers, |a|^2
    const float* qrow = qg + (size_t)min(i, la - 1) * f_dim;
    float q[walk::QF];
    const float sqa = walk::load_own(q, qrow, f_dim);
    // lane 0 of row 0 starts from D(-1,-1) = 0
    Lane st{BIG, BIG, (lane == 0 && r0 == 0) ? 0.f : BIG, BIG};
    for (int t0 = 0; t0 < n_steps; t0 += TILE) {
      if (WINDOW) {
        const int c = t0 + lane;
        edge[lane] = (r0 > 0 && c < lb) ? gedge[c] : BIG;
      }
      if (t0 < lb) {
        // 1. the strip's costs against template columns t0 .. t0 + 31
        const float* cols = tmpl + (size_t)t0 * fs;
        const float* csq = sqb + t0;
        if (WINDOW) {
          walk::stage_rows(win, bg, t0, TILE, lb - 1, f_dim, fs, lane);
          __syncwarp();
          wsq[lane] = walk::row_sq(win + lane * fs, fs);
          cols = win;
          csq = wsq;
        }
        __syncwarp();
        walk::cost_block(q, sqa, qrow, f_dim, cols, csq, t0, min(TILE, lb - t0), fs, tile,
                         lane, squared);
      }
      __syncwarp();
      // 2. the chunk's dependent steps
      const int n_here = n_steps - t0;
      const float* above = WINDOW ? edge : edge + t0;
      if (n_here >= TILE)
        steps<true>(st, tile, above, stage, lane, t0, TILE, lb, row_ok, j_end);
      else
        steps<false>(st, tile, above, stage, lane, t0, n_here, lb, row_ok, j_end);
      // 3. hand the last row's chunk (columns t0-31 .. t0) to the next strip;
      // lane 0 of this strip reads only columns > t0 from here on
      __syncwarp();
      const int col = t0 + lane - (TILE - 1);
      if (col >= 0 && col < lb && lane < n_here) (WINDOW ? gedge : edge)[col] = stage[lane];
      __syncwarp();
    }
    if (j_end >= 0) result = st.result;
  }
  // the lane that owns row la-1 holds the answer
  result = __shfl_sync(FULL, result, (la - 1) % TILE);
  if (lane == 0)
    out[(size_t)b * n_templates + k] = result / (float)(q_lens[b] + bank_lens[k]);
}

template <bool WINDOW>
cudaError_t configure(size_t smem) {
  return cudaFuncSetAttribute(dtw_fused_kernel<WINDOW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// warps a block and window mode come from the host's rule
// (kernels/dtw_fused.py:launch_plan); a block that does not fit fails here.
// Window mode takes `scratch`, n_queries x n_templates x u_pad floats of
// device memory for the edge rows (unused otherwise).
extern "C" int dtw_fused(const void* queries, const void* q_lens, const void* bank,
                         const void* bank_lens, void* out, void* scratch, int n_queries,
                         int n_templates, int t_pad, int u_pad, int f_dim, int squared,
                         int warps, int window, void* stream) {
  if (warps < 1 || warps > MAX_WARPS || t_pad < 1 || u_pad < 1 || f_dim < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(warps, u_pad, f_dim, window != 0);
  cudaError_t err = window ? configure<true>(smem) : configure<false>(smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so it cannot surface at the next launch
    return (int)err;
  }
  dim3 grid(n_templates, (n_queries + warps - 1) / warps);
  auto kernel = window ? dtw_fused_kernel<true> : dtw_fused_kernel<false>;
  kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)queries, (const int*)q_lens, (const float*)bank,
      (const int*)bank_lens, (float*)out, (float*)scratch, n_queries, n_templates, t_pad,
      u_pad, f_dim, squared);
  return (int)cudaGetLastError();
}

// Resident blocks an SM and registers a thread of the staged kernel at
// `warps` warps a block (no launch).
extern "C" int dtw_fused_occupancy(int warps, int u_pad, int f_dim,
                                   int* blocks_per_sm, int* regs) {
  if (warps < 1 || warps > MAX_WARPS || u_pad < 1 || f_dim < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(warps, u_pad, f_dim, false);
  auto kernel = dtw_fused_kernel<false>;
  cudaError_t err = configure<false>(smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, warps * 32,
                                                        smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  *regs = attr.numRegs;
  return 0;
}
