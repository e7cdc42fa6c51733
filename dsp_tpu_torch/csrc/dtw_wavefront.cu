// Wavefront DTW over a precomputed masked cost, one warp per pair.
//
// Replaces the TPU kernel dsp_tpu/kernels/dtw_pallas.py
// (dtw_from_cost_pallas / _dtw_kernel): masked cost [P,T,U] (BIG = 1e30 at
// cells outside the lengths, band and window, as ops/dtw.py:masked_cost
// builds it) + lengths [P] -> D(la-1, lb-1) / (la + lb) [P], with
//
//   D(i,j) = c(i,j) + min(D(i,j-1), min(D(i-1,j), D(i-1,j-1))),
//   D(-1,-1) = 0 and every other cell outside the matrix BIG,
//
// which is the TPU kernel's diagonal recurrence
// d_k[i] = c_k[i] + min(d_{k-1}[i], d_{k-1}[i-1], d_{k-2}[i-1]) written in
// (row, column) terms.  Each cell is one exact min and one add of the same
// operands, so any evaluation order gives the same bits as the plain
// version (kernels/dtw_pallas.py:dtw_from_cost_plain) at every reachable
// cell; "Unreachable pairs" below says what differs past BIG.
//
// What bounds it on the H100: device memory.  The DP does two mins and an
// add a cell against 4 bytes of cost read a cell, and it reads only the
// cells i < la, j < lb (1.26 GB of the 4.01 GB cost of one 256-query chunk
// against 100 templates at T = U = 198): 0.377 ms at 3.35 TB/s.  The
// first design took 2.05 ms there (0.63 TB/s on an H100 80GB HBM3 at
// 700 W): a warp had no bytes in flight while it stepped, it fenced every
// step with __syncwarp, and lane 0 took a two-level branch a step to read
// the row above.
//
// Design.  A warp walks its pair in strips of 32 rows: lane l owns row
// r0 + l and at step s of a chunk computes column t0 + s - l, so the row
// above arrives from lane l-1 by one register shuffle and no block barrier
// is needed.  The cost is read in chunks of 32 steps: 32 coalesced row
// reads (row r0 + r, columns t0 - r .. t0 - r + 31) stored into a 32 x 33
// shared tile, so the skew happens in shared memory, free of bank
// conflicts.  What keeps bytes in flight:
// * The next chunk's 32 loads (the next strip's first, at a strip's end)
//   are issued into registers before this chunk's 32 steps and stored into
//   the tile after them (E1's register prefetch, csrc/mb_wavefront.cu), so
//   every warp has 4 KB in flight while it steps.  The cost's rows are not
//   16-byte aligned at U = 198, so the loads are 4 bytes a lane.
// * Two __syncwarp a chunk, none a step: the shuffle carries the row above
//   inside a strip; lane 31 stages the strip's last row in `stage` and the
//   warp copies it into `edge` after the chunk, at columns lane 0 of the
//   strip never reads again.
// * Few instructions a step (the chip time is issue and latency, not the
//   DP's arithmetic): lane 0 reads the row above from `edge` at its own
//   column, one broadcast load with no bound to test, since `edge` is BIG
//   above row 0 and past column lb-1; the origin D(-1,-1) = 0 is lane 0's
//   first diagonal value, not a test a step.
// * A strip walks lb + (its rows - 1) steps, not lb + 31, and its last
//   chunk only the steps left.
// * Warps a block.  A block frees its slot on the SM only when its longest
//   pair ends.  At the main shape (lengths in [20, 198]) that leaves 33 %
//   of warp time idle at 8 warps a block and 27 % at 4; the wrapper takes
//   4 (kernels/dtw_pallas.py:BLOCK_WARPS; times in PERF.md, kernel 5).
//   Registers are capped at 64 a thread for 32 warps an SM (4 KB each in
//   flight); a warp's state is 5.4 KB of shared memory at U = 198.

// Unreachable pairs: the kernel takes every cell outside the matrix as
// exactly BIG, where the plain version's skewed padding sums BIG onto BIG.
// A distance that is finite has the same bits either way (its path and
// every candidate below BIG are the same cells); a pair that no finite
// path reaches comes out >= 1e20 in both, with bits that may differ where
// BIG cells lie scattered in its matrix.  On a masked cost as ops/dtw.py
// builds it every distance has been bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int MAX_WARPS = 8;    // pairs per block, one warp each
constexpr int TILE = 32;        // rows per strip = steps per staged chunk
constexpr int TS = TILE + 1;    // tile row stride
constexpr int PAD = 2 * TILE;   // BIG past the edge row's lb columns
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ __forceinline__ size_t warp_floats(int u_pad) {
  return (size_t)TILE * TS + TILE + u_pad + PAD;  // tile, staged last row, edge
}

// Row r0 + r, columns t0 - r .. t0 - r + 31 of a chunk (lane on column
// t0 - r + lane); cells outside i < la, j < lb are never used.
__device__ __forceinline__ void load_chunk(float (&v)[TILE], const float* c, int r0,
                                           int t0, int la, int lb, int u_pad, int lane) {
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    const int row = r0 + r, col = t0 + lane - r;
    v[r] = (row < la && (unsigned)col < (unsigned)lb) ? __ldg(c + (size_t)row * u_pad + col)
                                                       : BIG;
  }
}

__device__ __forceinline__ void store_chunk(const float (&v)[TILE], float* tile, int lane) {
#pragma unroll
  for (int r = 0; r < TILE; ++r) tile[r * TS + lane] = v[r];
}

// The DP state a lane carries from step to step.
struct Lane {
  float left;     // D(i, j-1)
  float last;     // this lane's value at the previous step
  float up_prev;  // D(i-1, j-1): the value above at the previous step
  float result;   // D(la-1, lb-1), in the lane that owns row la-1
};

// Steps t0 .. t0 + n - 1 of a strip over the staged chunk: lane l on
// column j = t0 + s - l.  Lane 0 takes the row above from `edge` (BIG past
// column lb-1, and everywhere above row 0), the others from lane l-1.
// FULL_CHUNK: all 32 steps, no step count to test.
template <bool FULL_CHUNK>
__device__ __forceinline__ void steps(Lane& st, const float* tile, const float* edge,
                                      float* stage, int lane, int t0, int n, int lb,
                                      bool row_ok, int j_end) {
#pragma unroll
  for (int s = 0; s < TILE; ++s) {
    if (!FULL_CHUNK && s >= n) break;
    const int j = t0 + s - lane;
    const float cv = tile[lane * TS + s];
    const float up_e = edge[t0 + s];            // lane 0's column: one broadcast load
    float up = __shfl_up_sync(FULL, st.last, 1);  // D(i-1, j) from lane l-1
    if (lane == 0) up = up_e;
    const bool ok = row_ok && (unsigned)j < (unsigned)lb;
    const float val = ok ? cv + fminf(st.left, fminf(up, st.up_prev)) : BIG;
    if (lane == TILE - 1) stage[s] = val;
    if (j == j_end) st.result = val;
    st.left = val;
    st.up_prev = up;
    st.last = val;
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32, 1024 / (MAX_WARPS * 32))
dtw_wavefront_kernel(const float* __restrict__ cost, const int* __restrict__ len_a,
                     const int* __restrict__ len_b, float* __restrict__ out,
                     int n_pairs, int t_pad, int u_pad) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * warps + warp;
  if (p >= n_pairs) return;  // whole warp: no block barrier follows
  float* tile = smem + warp * warp_floats(u_pad);  // [TILE][TS] skewed chunk
  float* stage = tile + TILE * TS;                 // [TILE] the last row's chunk
  float* edge = stage + TILE;                      // [u_pad + PAD] D of row r0 - 1
  const int la = min(max(len_a[p], 1), t_pad);
  const int lb = min(max(len_b[p], 1), u_pad);
  const float* c = cost + (size_t)p * t_pad * u_pad;

  float v[TILE];
  load_chunk(v, c, 0, 0, la, lb, u_pad, lane);
  store_chunk(v, tile, lane);
  // the row above row 0, and the columns past lb-1 of every row above: BIG
  // (lane 0 reads columns up to lb + 61; hand-offs write only those < lb)
  for (int x = lane; x < lb + PAD; x += 32) edge[x] = BIG;
  __syncwarp();

  // lane 0 of row 0 starts from D(-1,-1) = 0
  Lane st{BIG, BIG, lane == 0 ? 0.f : BIG, BIG};
  int r0 = 0, t0 = 0;
  for (;;) {
    const int i = r0 + lane;
    const int n_steps = lb + min(TILE, la - r0) - 1;  // to the strip's last row's end
    // the chunk after this one, in this strip or the next
    int nr0 = r0, nt0 = t0 + TILE;
    if (nt0 >= n_steps) {
      nr0 = r0 + TILE;
      nt0 = 0;
    }
    const bool more = nr0 < la;
    if (more) load_chunk(v, c, nr0, nt0, la, lb, u_pad, lane);

    const bool row_ok = i < la;
    const int j_end = i == la - 1 ? lb - 1 : -1;  // the answer's column in this row
    // the steps past n_steps compute no cell and hand off no column < lb
    const int n_here = n_steps - t0;
    if (n_here >= TILE)
      steps<true>(st, tile, edge, stage, lane, t0, TILE, lb, row_ok, j_end);
    else
      steps<false>(st, tile, edge, stage, lane, t0, n_here, lb, row_ok, j_end);
    __syncwarp();
    // hand the last row's chunk (columns t0-31 .. t0) to the next strip;
    // lane 0 of this strip reads only columns > t0 + 31 from here on
    const int col = t0 + lane - (TILE - 1);
    if (col >= 0 && col < lb && lane < n_here) edge[col] = stage[lane];
    if (!more) break;
    store_chunk(v, tile, lane);
    __syncwarp();
    if (nr0 != r0) st = Lane{BIG, BIG, BIG, st.result};  // a new strip
    r0 = nr0;
    t0 = nt0;
  }
  // the lane that owns row la-1 holds the answer
  const float result = __shfl_sync(FULL, st.result, (la - 1) % TILE);
  if (lane == 0) out[p] = result / (float)(len_a[p] + len_b[p]);
}

size_t wavefront_smem_bytes(int warps, int u_pad) {
  return sizeof(float) * warps * warp_floats(u_pad);
}

}  // namespace

extern "C" int dtw_wavefront(const void* cost, const void* len_a, const void* len_b,
                             void* out, int n_pairs, int t_pad, int u_pad, int warps,
                             void* stream) {
  if (warps < 1 || warps > MAX_WARPS || t_pad < 1 || u_pad < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wavefront_smem_bytes(warps, u_pad);
  cudaError_t err = cudaFuncSetAttribute(
      dtw_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so it cannot surface at the next launch
    return (int)err;
  }
  dim3 grid((n_pairs + warps - 1) / warps);
  dtw_wavefront_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)cost, (const int*)len_a, (const int*)len_b, (float*)out, n_pairs,
      t_pad, u_pad);
  return (int)cudaGetLastError();
}

// Resident blocks an SM and registers a thread of the kernel at `warps`
// warps a block and u_pad template frames (no launch).
extern "C" int dtw_wavefront_occupancy(int warps, int u_pad, int* blocks_per_sm,
                                       int* regs) {
  if (warps < 1 || warps > MAX_WARPS || u_pad < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = wavefront_smem_bytes(warps, u_pad);
  cudaError_t err = cudaFuncSetAttribute(
      dtw_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, dtw_wavefront_kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, dtw_wavefront_kernel,
                                                        warps * 32, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  *regs = attr.numRegs;
  return 0;
}
