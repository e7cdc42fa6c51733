// All-pairs subsequence DTW (keyword spotting), one warp per (stream,
// template) pair.
//
// Replaces the TPU kernel dsp_tpu/kernels/spot_fused.py
// (subseq_dtw_fused / _kernel): streams [B,U,F] x bank [K,T,F] ->
// norm [B,K,U] f32 and start [B,K,U] i32, the open-begin / open-end DP of
// dsp_tpu/golden/spot.py with a start witness per cell:
//
//   row 0:      D = c,                 s = j      (open begin)
//   column 0:   D = D(i-1,0) + c,      s = s(i-1,0)
//   elsewhere:  candidates diagonal D(i-1,j-1), vertical D(i-1,j),
//               horizontal D(i,j-1), in that order; a later candidate
//               replaces an earlier one only when strictly smaller
//               (diagonal vs vertical compared raw, the horizontal
//               against min(diagonal, vertical) after adding c, as the
//               plain scan's combine does).
//   harvest:    at row tl-1, norm[j] = D / (tl + j - s + 1), start[j] = s;
//               norm = 1e30 and start = j for j >= len_stream.
//
// The local cost is the expanded form max(|a|^2 + |b|^2 - 2 a.b, 0), then
// sqrtf unless `squared`: the form of the plain version
// (dsp_tpu_torch/ops/spot.py via ops/dtw.py:pairwise_sq_cost) and of the
// TPU kernel, so near-identical frames leave the same kind of residue in
// both.  Lengths are clamped to >= 1, as the TPU kernel does.
//
// What bounds it on the H100: fp32 SIMT operations.  Each of the
// sum(tl * sl) cells costs an F-long dot product (~2F+3 flops with the
// DP), while the [B,K,U] outputs cost ~9 us at 3.35 TB/s at the bench_all
// spotting shape.  The first design (one block a pair, thread i on
// template row i, a block barrier on every anti-diagonal, each cell's
// stream frame read as F scalar shared loads) took 18.7x its bound there
// and refused templates past 1,024 frames, and at F = 128 past ~400.
//
// Design: the walk of csrc/dtw_fused.cu turned on its side, so that the
// state is one column of the template's length and never grows with the
// stream (the pieces shared with kernel 4 are in csrc/warp_walk.cuh).
// * One warp a strip of 32 stream columns; lane l owns column c0 + l.  At
//   step s the lane is on template row s - l: the horizontal predecessor
//   D(i, j-1) and its witness arrive from lane l-1 by two __shfl_sync,
//   the vertical one is the lane's own last value, the diagonal one what it
//   received a step before.  No block barrier separates the steps.  A strip
//   walks tl + cols - 1 steps.
// * The costs are off the dependent chain.  The lane holds its stream frame
//   in registers (40 features at a time; wider features are summed 40 at a
//   time) with |b|^2.  At the start of each chunk of 32 steps, t0 = 32m
//   (t0 < tl), it computes its frame's costs against template rows t0 ..
//   t0 + 31 (those < tl, eight at a time), reading each template row as
//   float4 broadcasts, into a 64-row ring (swizzled, free of bank
//   conflicts) that holds this block and the one before.
// * The last column of a strip (D and the witness of every template row)
//   reaches the next strip through an edge column: lane 31 stages a chunk's
//   values and the warp copies them after the chunk's __syncwarp.
// * W warps a stream (the host's choice, doubled while the pairs' warps fit
//   what the card holds: 1 where the pairs fill the card, 2 for 4 streams
//   of 60 s against 100 templates, up to 8 for fewer): warp w walks strips
//   w, w + W, ... of its pair, each warp one strip behind the last, and
//   reads the edge column its neighbour w - 1 writes.  Before its chunk c
//   a warp waits until the neighbour has done its chunk c + 1 (a counter in
//   shared memory, released and acquired at block scope): one wait and one
//   release a chunk, none a step.  A warp
//   overwrites its edge column only after the neighbour it feeds has read
//   those rows, because that neighbour's progress is a precondition of the
//   writer's own, W - 1 warps up the chain.  With W = 1 a warp reads and
//   writes one edge column in place, at rows it no longer reads.
// * A block holds up to 8 warps: W warps for each of up to 8 / W streams
//   against one template, which is staged once with its |a_i|^2; where the
//   whole template does not fit the block (at F = 39 past 1,280 frames for
//   one warp), each warp stages the 32 template rows of a chunk itself
//   (window mode), and the edge columns live in device memory (`scratch`,
//   2 x t_pad words a warp), so no length is bounded by shared memory: any
//   stream, template and feature width runs.
// * The harvest (D and the witness at row tl-1) stays in registers until
//   the strip ends; then each lane writes its column's norm (coalesced).
// * On an NVIDIA H100 80GB HBM3 at 700 W this takes 1.28 ms at the
//   bench_all spotting shape and 4.79 ms on 60 s streams (2.39 and 5.21 ms
//   the first design; PERF.md, kernel 3).
// * kernels/spot_fused.py states the walk (strips, cost_cells), the launch
//   (launch_plan: window mode, warps a stream, warps a block) and window
//   mode's stream slices (window_rows) in Python.

#include <cuda/atomic>

#include "warp_walk.cuh"

namespace {

using walk::BIG;
using walk::FULL;
using walk::RING;
using walk::TILE;
using walk::round_up;
using walk::feature_stride;

constexpr int MAX_WARPS = 8;            // warps a block
constexpr int PAD = 64;                 // rows past the edge column's tl

// Words of one warp's region: the window of 32 template rows and their
// |a|^2 (window mode), the cost ring, the staged last column (D, s), the
// edge column (D, s; window mode: the chunk's 32 rows of it, the column
// being in device memory).
__host__ __device__ __forceinline__ size_t warp_words(int t_pad, int fs, bool window) {
  return (window ? (size_t)TILE * fs + TILE : 0) + RING * TILE + 2 * TILE +
         2 * (size_t)(window ? TILE : round_up(t_pad + PAD, 4));
}

// Shared bytes of a block; mirrored by kernels/spot_fused.py:smem_bytes.
size_t smem_bytes(int warps, int t_pad, int f_dim, bool window) {
  const int fs = feature_stride(f_dim);
  const size_t rows = round_up(t_pad, TILE);
  const size_t staged = window ? 0 : rows * fs + rows;
  return 4 * (staged + warps * warp_words(t_pad, fs, window) + MAX_WARPS);
}

// The DP state a lane carries from step to step.
struct Lane {
  float d;        // D of this lane's last cell (row i-1 at the next step)
  int s;
  float dg;       // D(i-1, j-1): what arrived from lane l-1 a step before
  int sg;
  float h_d;      // D and the witness at row tl-1: the harvest
  int h_s;
};

// Steps t0 .. t0 + n - 1 of a strip: lane l on row i = t0 + s - l of
// column j, its cost at tile[tile_at(i, lane)].  Lane 0 takes the column to
// the left from (left_d, left_s)[s] (row t0 + s), which lane 31 (whose own
// values only the next strip reads) sends in its place, so the broadcast
// loads stay off the dependent chain; the others from lane l-1.  The
// candidates are chosen by selects, in the order of the header's rule.
template <bool FULL_CHUNK>
__device__ __forceinline__ void steps(Lane& st, const float* __restrict__ tile,
                                      const float* __restrict__ left_d,
                                      const int* __restrict__ left_s, float* __restrict__ stage_d,
                                      int* __restrict__ stage_s, int lane, int t0, int n, int tl,
                                      int j, bool jpos) {
  const int from = (lane - 1) & 31;
#pragma unroll
  for (int s = 0; s < TILE; ++s) {
    if (!FULL_CHUNK && s >= n) break;
    const int i = t0 + s - lane;
    const float c = tile[walk::tile_at(i, lane)];
    const bool last_lane = lane == TILE - 1;
    const float h_d = __shfl_sync(FULL, last_lane ? left_d[s] : st.d, from);  // D(i, j-1)
    const int h_s = __shfl_sync(FULL, last_lane ? left_s[s] : st.s, from);
    // vertical D(i-1, j) against diagonal D(i-1, j-1), the diagonal winning ties
    const bool diag = jpos && !(st.d < st.dg);
    float dv = __fadd_rn(diag ? st.dg : st.d, c);
    int sv = diag ? st.sg : st.s;
    // the horizontal only when strictly smaller
    const float hz = __fadd_rn(h_d, c);
    const bool horiz = jpos && hz < dv;
    dv = horiz ? hz : dv;
    sv = horiz ? h_s : sv;
    // row 0: a fresh start; rows outside the template: BIG
    const bool valid = (unsigned)i < (unsigned)tl;
    dv = i == 0 ? c : (valid ? dv : BIG);
    sv = i == 0 || !valid ? j : sv;
    const bool harvest = i == tl - 1;
    st.h_d = harvest ? dv : st.h_d;
    st.h_s = harvest ? sv : st.h_s;
    st.d = dv;
    st.s = sv;
    if (last_lane) {
      stage_d[s] = dv;
      stage_s[s] = sv;
    }
    st.dg = h_d;
    st.sg = h_s;
  }
}

template <bool WINDOW>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
spot_subseq_kernel(const float* __restrict__ streams, const int* __restrict__ stream_lens,
                   const float* __restrict__ bank, const int* __restrict__ bank_lens,
                   float* __restrict__ norm_out, int* __restrict__ start_out,
                   float* __restrict__ scratch, int n_streams, int n_templates, int u_pad,
                   int t_pad, int f_dim, int squared, int w_pair) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int w = warp % w_pair;          // this warp's place among its stream's warps
  const int k = blockIdx.x;
  const int b = blockIdx.y * (warps / w_pair) + warp / w_pair;
  const int fs = feature_stride(f_dim);
  const int tl = min(max(bank_lens[k], 1), t_pad);
  const int rows = round_up(t_pad, TILE);
  const float* tg = bank + (size_t)k * t_pad * f_dim;

  // stage the template once for the block's warps, with |a_i|^2, up to a
  // whole cost block (rows past tl repeat row tl-1; their costs are never
  // used); in window mode each warp stages a chunk's rows instead
  float* tmpl = smem;                                   // [rows][fs]
  float* sqa = tmpl + (size_t)rows * fs;                // [rows]
  int* done = reinterpret_cast<int*>(smem + (WINDOW ? 0 : (size_t)rows * fs + rows) +
                                     warps * warp_words(t_pad, fs, WINDOW));  // [warps]
  if (!WINDOW) {
    const int n = round_up(tl, TILE);
    const int per = (n + warps - 1) / warps;            // rows a warp stages
    const int lo = min(n, warp * per);
    walk::stage_rows(tmpl + (size_t)lo * fs, tg, lo, min(n, lo + per) - lo, tl - 1, f_dim, fs,
                     lane);
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += blockDim.x) sqa[r] = walk::row_sq(tmpl + (size_t)r * fs, fs);
  }
  if (threadIdx.x < warps) done[threadIdx.x] = 0;
  __syncthreads();
  if (b >= n_streams) return;           // the stream's whole warp group: no block barrier follows

  const size_t ww = warp_words(t_pad, fs, WINDOW);
  float* win = smem + (WINDOW ? 0 : (size_t)rows * fs + rows) + warp * ww;  // [TILE][fs]
  float* wsq = win + (WINDOW ? TILE * fs : 0);          // [TILE]
  float* tile = wsq + (WINDOW ? TILE : 0);              // [RING][TILE] the lanes' costs
  float* stage_d = tile + RING * TILE;                  // [TILE] the last column's chunk
  int* stage_s = reinterpret_cast<int*>(stage_d + TILE);
  // the edge column this warp writes: staged mode [tl + PAD] D and s here;
  // window mode [t_pad] D and s in device memory
  const int edge_n = WINDOW ? TILE : round_up(t_pad + PAD, 4);
  float* edge_d = stage_d + 2 * TILE;
  int* edge_s = reinterpret_cast<int*>(edge_d + edge_n);
  const int pw = (w + w_pair - 1) % w_pair;             // the warp whose column this one reads
  const float* src_d = edge_d + ((long long)pw - w) * (long long)ww;
  const int* src_s = edge_s + ((long long)pw - w) * (long long)ww;
  float* g_d = scratch + (((size_t)b * n_templates + k) * w_pair + w) * 2 * t_pad;
  int* g_s = reinterpret_cast<int*>(g_d + t_pad);
  const float* gsrc_d = g_d + ((long long)pw - w) * 2 * t_pad;
  const int* gsrc_s = g_s + ((long long)pw - w) * 2 * t_pad;
  cuda::atomic_ref<int, cuda::thread_scope_block> my_done(done[warp]);
  cuda::atomic_ref<int, cuda::thread_scope_block> src_done(done[warp - w + pw]);

  const int sl = min(max(stream_lens[b], 1), u_pad);
  const float* sg = streams + (size_t)b * u_pad * f_dim;
  float* norm_row = norm_out + ((size_t)b * n_templates + k) * u_pad;
  int* start_row = start_out + ((size_t)b * n_templates + k) * u_pad;
  if (w == 0)
    for (int j = sl + lane; j < u_pad; j += 32) {
      norm_row[j] = BIG;
      start_row[j] = j;
    }
  const int chunks_full = (tl + TILE - 1 + TILE - 1) / TILE;   // a full strip's chunks
  int n_done = 0;                       // chunks this warp has finished, in all its strips

  for (int c0 = w * TILE; c0 < sl; c0 += w_pair * TILE) {
    const int j = c0 + lane;
    const int n_cols = min(TILE, sl - c0);
    const int n_steps = tl + n_cols - 1;
    // the producer of this strip's left column: its finished chunks before
    // that strip (all strips before the last are full)
    const int src_base = (c0 / TILE - 1 - pw) / w_pair * chunks_full;
    // the lane's stream frame (frames past sl-1 repeat it) in registers, |b|^2
    const float* frame = sg + (size_t)min(j, sl - 1) * f_dim;
    float x[walk::QF];
    const float bsq = walk::load_own(x, frame, f_dim);
    Lane st{BIG, j, BIG, 0, BIG, j};
    for (int t0 = 0; t0 < n_steps; t0 += TILE) {
      // rows t0 .. t0 + 31 of the column to the left: from chunk c + 1 of
      // the strip before (lane 31 finishes row r at step r + 31)
      if (c0 > 0 && w_pair > 1 && lane == 0) {
        const int need = src_base + min(t0 / TILE + 2, chunks_full);
        while (src_done.load(cuda::memory_order_acquire) < need) __nanosleep(64);
      }
      __syncwarp();                     // lane 0's acquire, for every lane's reads
      if (WINDOW) {
        const int r = t0 + lane;
        const bool ok = c0 > 0 && r < tl;
        edge_d[lane] = ok ? (w_pair > 1 ? gsrc_d : g_d)[r] : BIG;
        edge_s[lane] = ok ? (w_pair > 1 ? gsrc_s : g_s)[r] : 0;
      }
      if (t0 < tl) {
        // 1. the strip's costs against template rows t0 .. t0 + 31
        const float* trows = tmpl + (size_t)t0 * fs;
        const float* tsq = sqa + t0;
        if (WINDOW) {
          walk::stage_rows(win, tg, t0, TILE, tl - 1, f_dim, fs, lane);
          __syncwarp();
          wsq[lane] = walk::row_sq(win + lane * fs, fs);
          trows = win;
          tsq = wsq;
        }
        __syncwarp();
        walk::cost_block(x, bsq, frame, f_dim, trows, tsq, t0, min(TILE, tl - t0), fs, tile,
                         lane, squared);
      }
      __syncwarp();
      // 2. the chunk's dependent steps
      const int n_here = n_steps - t0;
      const float* left_d = WINDOW ? edge_d : (w_pair > 1 ? src_d : edge_d) + t0;
      const int* left_s = WINDOW ? edge_s : (w_pair > 1 ? src_s : edge_s) + t0;
      if (n_here >= TILE)
        steps<true>(st, tile, left_d, left_s, stage_d, stage_s, lane, t0, TILE, tl, j, j > 0);
      else
        steps<false>(st, tile, left_d, left_s, stage_d, stage_s, lane, t0, n_here, tl, j,
                     j > 0);
      // 3. hand the last column's chunk (rows t0-31 .. t0) to the next strip;
      // lane 0 of this strip reads only rows > t0 from here on
      __syncwarp();
      const int row = t0 + lane - (TILE - 1);
      if (row >= 0 && row < tl && lane < n_here) {
        (WINDOW ? g_d : edge_d)[row] = stage_d[lane];
        (WINDOW ? g_s : edge_s)[row] = stage_s[lane];
      }
      __syncwarp();
      ++n_done;
      if (w_pair > 1 && lane == 0) my_done.store(n_done, cuda::memory_order_release);
    }
    if (j < sl) {
      norm_row[j] = st.h_d / ((float)tl + (float)(j - st.h_s + 1));
      start_row[j] = st.h_s;
    }
  }
}

template <bool WINDOW>
cudaError_t configure(size_t smem) {
  return cudaFuncSetAttribute(spot_subseq_kernel<WINDOW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Window mode, warps a stream and warps a block come from the host's rule
// (kernels/spot_fused.py:launch_plan); a block that does not fit fails
// here.  Window mode takes `scratch`, n_streams x n_templates x w_pair x 2
// x t_pad words of device memory for the edge columns (unused otherwise).
extern "C" int spot_subseq(const void* streams, const void* stream_lens,
                           const void* bank, const void* bank_lens, void* norm,
                           void* start, void* scratch, int n_streams, int n_templates,
                           int u_pad, int t_pad, int f_dim, int squared, int warps,
                           int w_pair, int window, void* stream) {
  if (warps < 1 || warps > MAX_WARPS || w_pair < 1 || warps % w_pair != 0 || t_pad < 1 ||
      u_pad < 1 || f_dim < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(warps, t_pad, f_dim, window != 0);
  cudaError_t err = window ? configure<true>(smem) : configure<false>(smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch's check does not see it
    return (int)err;
  }
  const int per_block = warps / w_pair;
  dim3 grid(n_templates, (n_streams + per_block - 1) / per_block);
  auto kernel = window ? spot_subseq_kernel<true> : spot_subseq_kernel<false>;
  kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)streams, (const int*)stream_lens, (const float*)bank,
      (const int*)bank_lens, (float*)norm, (int*)start, (float*)scratch, n_streams,
      n_templates, u_pad, t_pad, f_dim, squared, w_pair);
  return (int)cudaGetLastError();
}

// Resident blocks an SM and registers a thread of the staged kernel at
// `warps` warps a block (no launch).
extern "C" int spot_subseq_occupancy(int warps, int t_pad, int f_dim,
                                     int* blocks_per_sm, int* regs) {
  if (warps < 1 || warps > MAX_WARPS || t_pad < 1 || f_dim < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(warps, t_pad, f_dim, false);
  auto kernel = spot_subseq_kernel<false>;
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
