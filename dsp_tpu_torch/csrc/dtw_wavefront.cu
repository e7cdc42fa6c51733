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
// version (kernels/dtw_pallas.py:dtw_from_cost_plain).
//
// What bounds it on the H100: device memory.  The DP does two mins and an
// add per cell, while the cost it reads is 4 bytes per cell (4.0 GB for one
// 256-query chunk against 100 templates at T = U = 198), so the least time
// is the cost's bytes over 3.35 TB/s.  The answer depends only on the cells
// i < la, j < lb, and the kernel reads only those.
//
// Design.  The TPU kernel read a pre-skewed copy of the cost (one diagonal
// per contiguous slab); building that copy was an extra pass over the whole
// tensor.  Here no skewed copy exists in device memory.  A warp walks its
// pair in strips of 32 rows: lane l owns row r0 + l and at step t computes
// column t - l, so the row above arrives from lane l-1 by a register
// shuffle and no block barrier is needed.  Lane l reads its row left to
// right, so reading device memory directly would put neighbouring lanes a
// row apart (one 32-byte sector per 4-byte value).  Instead the warp stages
// each chunk of 32 steps into a 32 x 33 shared tile with 32 coalesced row
// reads (row r, columns t0 - r .. t0 - r + 31), i.e. the skew happens in
// shared memory; the odd row stride keeps both the staging writes and the
// skewed reads free of bank conflicts.  The last row of a strip is kept in
// shared memory for lane 0 of the next strip.  State per warp: 5.2 KB at
// U = 198, so many warps share an SM and hide each other's load latency.

#include <cuda_runtime.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int WARPS = 8;        // pairs per block, one warp each
constexpr int TILE = 32;        // rows per strip = steps per staged chunk
constexpr int TS = TILE + 1;    // tile row stride
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
dtw_wavefront_kernel(const float* __restrict__ cost, const int* __restrict__ len_a,
                     const int* __restrict__ len_b, float* __restrict__ out,
                     int n_pairs, int t_pad, int u_pad) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int p = blockIdx.x * WARPS + warp;
  if (p >= n_pairs) return;  // whole warp: no block barrier follows
  float* tile = smem + warp * (TILE * TS + u_pad);  // [TILE][TS] skewed chunk
  float* edge = tile + TILE * TS;                   // [u_pad] D of row r0 - 1
  const int la = min(max(len_a[p], 1), t_pad);
  const int lb = min(max(len_b[p], 1), u_pad);
  const float* c = cost + (size_t)p * t_pad * u_pad;
  float result = BIG;
  for (int r0 = 0; r0 < la; r0 += TILE) {
    const int i = r0 + lane;
    float left = BIG;     // D(i, j-1)
    float last = BIG;     // this lane's value at the previous step
    float up_prev = BIG;  // D(i-1, j-1): the value received at the previous step
    const int n_steps = lb + TILE - 1;
    for (int t0 = 0; t0 < n_steps; t0 += TILE) {
      __syncwarp();
      float v[TILE];
#pragma unroll
      for (int r = 0; r < TILE; ++r) {  // coalesced: lanes on consecutive columns
        const int row = r0 + r, col = t0 + lane - r;
        v[r] = (row < la && col >= 0 && col < lb) ? c[(size_t)row * u_pad + col] : BIG;
      }
#pragma unroll
      for (int r = 0; r < TILE; ++r) tile[r * TS + lane] = v[r];
      __syncwarp();
      for (int s = 0; s < TILE; ++s) {
        const int j = t0 + s - lane;
        float up = __shfl_up_sync(FULL, last, 1);  // D(i-1, j) from lane l-1
        float diag = up_prev;
        if (lane == 0) {  // row r0 - 1: the previous strip's last row, or row -1
          if (r0 == 0) {
            up = BIG;
            diag = (j == 0) ? 0.f : BIG;  // the origin D(-1,-1) = 0
          } else {
            up = (j >= 0 && j < lb) ? edge[j] : BIG;
            diag = (j >= 1 && j <= lb) ? edge[j - 1] : BIG;
          }
        }
        float val = BIG;
        if (j >= 0 && j < lb && i < la) {
          val = tile[lane * TS + s] + fminf(left, fminf(up, diag));
          left = val;
          if (lane == TILE - 1) edge[j] = val;
          if (i == la - 1 && j == lb - 1) result = val;
        }
        up_prev = up;
        last = val;
        __syncwarp();
      }
    }
  }
  // the lane that owns row la-1 holds the answer
  const int owner = (la - 1) % TILE;
  result = __shfl_sync(FULL, result, owner);
  if (lane == 0) out[p] = result / (float)(len_a[p] + len_b[p]);
}

}  // namespace

extern "C" int dtw_wavefront(const void* cost, const void* len_a, const void* len_b,
                             void* out, int n_pairs, int t_pad, int u_pad, void* stream) {
  size_t smem = sizeof(float) * (size_t)WARPS * (TILE * TS + u_pad);
  cudaError_t err = cudaFuncSetAttribute(
      dtw_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so it cannot surface at the next launch
    return (int)err;
  }
  dim3 grid((n_pairs + WARPS - 1) / WARPS);
  dtw_wavefront_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)cost, (const int*)len_a, (const int*)len_b, (float*)out, n_pairs,
      t_pad, u_pad);
  return (int)cudaGetLastError();
}
