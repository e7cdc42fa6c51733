// Unbanded all-pairs DTW in closed form, one thread block per (query,
// template) pair; the cost never reaches device memory.
//
// Replaces the TPU kernel dsp_tpu/kernels/dtw_fused.py (dtw_batch_fused /
// _fused_kernel): queries [B,T,F] x bank [K,U,F] -> distances [B,K] =
// D(la-1, lb-1) / (q_len + bank_len), unbanded, steps {(1,0),(0,1),(1,1)}.
// Per row i the min-plus row recurrence D_j = c_j + min(m_j, D_{j-1}),
// m_j = min(D_{i-1,j}, D_{i-1,j-1}), is solved in the closed form of the
// TPU kernel:
//
//   c_j  = sqrt(max(|a_i|^2 + |b_j|^2 - 2 a_i.b_j, 0))   (or its square),
//          BIG = 1e30 at j >= lb (a suffix, so prefix sums stay finite)
//   CS_j = c_0 + ... + c_j
//   e_j  = m_j - CS_{j-1} at j < lb, BIG elsewhere   (CS_{-1} = 0)
//   D_j  = CS_j + min(e_0, ..., e_j)
//
// with m_0 = 0 on row 0 (the origin) and BIG on later rows.  The plain
// version (kernels/dtw_fused.py:dtw_batch_fused_plain) is the same closed
// form in PyTorch; the two differ only in rounding (the sums run in
// another order), so distances agree to about 1e-6 relative.
//
// What bounds it on the H100: operations.  Each cell costs an F-long dot
// product (2F flops) and the DP; the features read are ~12 MB for a chunk
// of 256 queries x 100 templates.  The design keeps everything on chip:
// thread j owns template column j and holds that row of the template in
// registers, the query rows sit in shared memory and are read as float4
// broadcasts, and a row's two scans (a prefix sum, then a prefix min) run
// as warp shuffles with one cross-warp step in shared memory each, so a row
// costs two block barriers.  State is O(U) plus the query: there is no
// [T, U] tile, so the query length is limited only by the query's shared
// memory (T * 4 * round_up(F, 4) bytes) and the template length by the
// 1,024 threads of a block.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_incl_sum(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    float y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = __fadd_rn(y, x);
  }
  return x;
}

__device__ __forceinline__ float warp_incl_min(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    float y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = fminf(y, x);
  }
  return x;
}

// NF4: float4 chunks of the template row held in registers (F <= 4 * NF4).
template <int NF4>
__global__ void dtw_fused_kernel(const float* __restrict__ queries,
                                 const int* __restrict__ q_lens,
                                 const float* __restrict__ bank,
                                 const int* __restrict__ bank_lens,
                                 float* __restrict__ out, int n_templates, int t_pad,
                                 int u_pad, int f_dim, int fs, int squared) {
  extern __shared__ float4 smem4[];
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const int lane = j % 32, warp = j / 32;
  const int nf4 = fs / 4;
  float* q_s = reinterpret_cast<float*>(smem4);  // [t_pad, fs], zero-padded features
  float* sqa = q_s + (size_t)t_pad * fs;         // [t_pad] |a_i|^2
  float* wsum = sqa + t_pad;                     // [32] per-warp sums
  float* wmin = wsum + 32;                       // [32] per-warp mins
  float* dlast = wmin + 32;                      // [32] D of each warp's last column

  const int la = min(max(q_lens[b], 1), t_pad);
  const int lb = min(max(bank_lens[k], 1), u_pad);
  const float* qg = queries + (size_t)b * t_pad * f_dim;
  for (int idx = j; idx < la * fs; idx += blockDim.x) {
    int r = idx / fs, f = idx - r * fs;
    q_s[idx] = f < f_dim ? qg[(size_t)r * f_dim + f] : 0.f;
  }
  // this thread's template row, zero-padded to 4 * NF4 features
  float4 brow[NF4];
  float sqb = 0.f;
  const float* bg = bank + ((size_t)k * u_pad + min(j, u_pad - 1)) * f_dim;
#pragma unroll
  for (int c = 0; c < NF4; ++c) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int f = 4 * c + e;
      v[e] = (j < lb && f < f_dim) ? bg[f] : 0.f;
      sqb = fmaf(v[e], v[e], sqb);
    }
    brow[c] = make_float4(v[0], v[1], v[2], v[3]);
  }
  if (j < 32) dlast[j] = BIG;  // row -1: no predecessor above the first row
  __syncthreads();
  for (int r = j; r < la; r += blockDim.x) {
    float s = 0.f;
    for (int f = 0; f < f_dim; ++f) s = fmaf(q_s[r * fs + f], q_s[r * fs + f], s);
    sqa[r] = s;
  }
  __syncthreads();

  float dp = BIG;   // D(i-1, j)
  float res = BIG;  // D(la-1, j)
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  for (int i = 0; i < la; ++i) {
    float c = BIG;
    if (j < lb) {
      float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f;
#pragma unroll
      for (int cc = 0; cc < NF4; ++cc) {
        if (cc < nf4) {
          float4 a = q4[i * nf4 + cc];  // same address across the warp: a broadcast
          x0 = fmaf(a.x, brow[cc].x, x0);
          x1 = fmaf(a.y, brow[cc].y, x1);
          x2 = fmaf(a.z, brow[cc].z, x2);
          x3 = fmaf(a.w, brow[cc].w, x3);
        }
      }
      float cross = __fadd_rn(__fadd_rn(x0, x1), __fadd_rn(x2, x3));
      // (|a|^2 + |b|^2) - 2 a.b, rounded as the plain version (no contraction)
      float sq = fmaxf(__fsub_rn(__fadd_rn(sqa[i], sqb), __fmul_rn(2.f, cross)), 0.f);
      c = squared ? sq : sqrtf(sq);
    }
    // ---- block prefix sum of c: CS_j, and CS_{j-1}
    float x = warp_incl_sum(c, lane);
    if (lane == 31) wsum[warp] = x;
    float dl = __shfl_up_sync(FULL, dp, 1);  // D(i-1, j-1) within the warp
    __syncthreads();
    float off = 0.f;
    for (int w = 0; w < warp; ++w) off = __fadd_rn(off, wsum[w]);
    const float cs = __fadd_rn(off, x);
    float cs_prev = __shfl_up_sync(FULL, cs, 1);
    if (lane == 0) {
      cs_prev = off;  // = the previous warp's last CS, summed in the same order
      dl = (j == 0) ? (i == 0 ? 0.f : BIG) : dlast[warp - 1];
    }
    // ---- block prefix min of e_j = m_j - CS_{j-1}
    const float m = fminf(dp, dl);
    float y = warp_incl_min(j < lb ? __fsub_rn(m, cs_prev) : BIG, lane);
    if (lane == 31) wmin[warp] = y;
    __syncthreads();
    for (int w = 0; w < warp; ++w) y = fminf(wmin[w], y);
    dp = __fadd_rn(cs, y);
    if (lane == 31) dlast[warp] = dp;  // read after the next row's first barrier
    if (i == la - 1) res = dp;
  }
  if (j == lb - 1)
    out[(size_t)b * n_templates + k] = res / (float)(q_lens[b] + bank_lens[k]);
}

}  // namespace

extern "C" int dtw_fused(const void* queries, const void* q_lens, const void* bank,
                         const void* bank_lens, void* out, int n_queries,
                         int n_templates, int t_pad, int u_pad, int f_dim, int squared,
                         void* stream) {
  if (u_pad < 1 || u_pad > 1024 || f_dim < 1 || f_dim > 128)
    return (int)cudaErrorInvalidValue;
  int fs = 4 * ((f_dim + 3) / 4);
  int threads = 32 * ((u_pad + 31) / 32);
  size_t smem = sizeof(float) * ((size_t)t_pad * fs + t_pad + 3 * 32);
  auto kernel = f_dim <= 40 ? dtw_fused_kernel<10> : dtw_fused_kernel<32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so it cannot surface at the next launch
    return (int)err;
  }
  dim3 grid(n_templates, n_queries);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)queries, (const int*)q_lens, (const float*)bank,
      (const int*)bank_lens, (float*)out, n_templates, t_pad, u_pad, f_dim, fs,
      squared);
  return (int)cudaGetLastError();
}
