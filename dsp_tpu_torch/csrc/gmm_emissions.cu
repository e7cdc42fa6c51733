// Emission log-likelihoods of every HMM state: diagonal Gaussian mixtures
// and their log-sum-exp, one launch.
//
// Replaces no TPU kernel: the JAX package scores its emissions with
// jnp.matmul products and a logsumexp that XLA fused
// (dsp_tpu/models/gmm_hmm.py), and the port's plain version is the same
// chain in PyTorch (models/gmm_hmm.py:gmm_loglik_flat, then
// torch.logsumexp): two fp32 GEMMs of the expanded form and a dozen
// elementwise passes and reductions over [rows, W S M] tensors (428 MB each
// at the main shape).  For each feature row x [F] and each state (p, s)
// of the parameter sets p [n_sets] with M diagonal Gaussians:
//
//   ll_m      = log_mix[p,s,m] - 0.5 (sum_f log_var[p,s,m,f] + F log 2 pi)
//               - 0.5 sum_f (x_f - mean[p,s,m,f])^2 exp(-log_var[p,s,m,f])
//   out[r,p,s] = logsumexp_m ll_m        (torch.logsumexp's rules: all -inf
//                                         gives -inf, a NaN propagates)
//
// The sum is the direct form the benchmark's float64 reference computes
// (benchmark/reference/gmm_hmm.py:log_emissions), fma(d*d, 1/var, acc) in
// order over f: no cancellation of the expanded form's large terms.
//
// What bounds it on the H100: fp32 operations.  At the main shape
// (202,752 rows, 11 x 16 x 3 = 528 Gaussians, F = 39) the work is
// 12.85 GFLOP as the benchmark counts it (3F + 3 a Gaussian and row),
// 0.19 ms at 67 TFLOP/s; the rows in (31.6 MB) and log_b out (142.7 MB)
// take 0.052 ms at 3.35 TB/s.  In instructions it is three fp32 ops an
// element (sub, mul, fma): 12.5 G lane operations, 0.37 ms at the SMs'
// 128 fp32 lanes a cycle and 1.98 GHz.
//
// Design.  A block takes a tile of 256 rows and one parameter set p (one
// word): the 1-D grid runs over (row tile, p), p fastest.  It stages the
// tile transposed in shared memory ([F][257]: lanes read consecutive
// rows, conflict-free) and, in stages of at most stage_states states, the
// set's means and 1/var = exp(-log_var) laid out for broadcast float4
// reads, with each Gaussian's constant log_mix - 0.5 (sum log_var + F log
// 2 pi) computed from the parameters as they are, so one call is one
// launch.  A thread holds 2 rows x ST states x M mixtures of accumulators
// in registers (ST = 4, or 2 past M = 4) and walks f: two row values and
// 2 ST M parameters from shared memory feed 6 ST M fp32 operations.  The
// log-sum-exp over M is taken in registers and each row's ST states are
// stored as one vector (a float4 at ST = 4) where S allows, so log_b is
// written once and no [rows, W S M] tensor exists.  Every row of the
// tile is computed; rows past the input are zeros and are not stored.
//
// Measured (H100 80GB HBM3, 700 W): 0.68-0.69 ms at the main shape, 3.6x
// the operations bound and 1.8x the three-instruction one; the plain
// chain 5.1 ms.  87 registers at M = 3, no spills, four blocks an SM
// (55,264 shared bytes each).  Variants measured against it: 1, 3 and 4
// rows a thread 0.83, 0.70 and 0.85 ms (fewer warps, or twice the
// parameter loads an operation); the log-sum-exp by __expf / __logf
// 0.66 ms; (x s - mu s)^2 with s = exp(-log_var / 2), two fmas an
// element, 0.59 ms, at the price of rounding mu s before the difference.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;                 // a block: 4 warps
constexpr int RPT = 2;                       // rows a thread: t, t + THREADS, ...
constexpr int ROWS = RPT * THREADS;          // rows a block
constexpr int X_STRIDE = ROWS + 1;           // shared row tile [F][X_STRIDE]
constexpr int BLOCKS_PER_SM = 4;             // 128 registers a thread at most
constexpr int MAX_MIX = 8;
constexpr int MAX_FEAT = 64;
constexpr int SMEM_OPTIN = 232448;           // shared bytes a block may use (227 KB)
constexpr float LOG_2PI = 1.8378770664093453f;

__host__ __device__ constexpr int state_tile(int m) { return m <= 4 ? 4 : 2; }

// floats before the parameter stage: the row tile, rounded up to a float4
__host__ __device__ inline int x_floats(int n_feat) { return (n_feat * X_STRIDE + 3) & ~3; }

// shared bytes of a block: the row tile, then a stage's means and inverse
// variances (2 M F a state) and its constants (M a state)
inline long long smem_bytes(int n_mix, int n_feat, int stage_states) {
  return 4LL * (x_floats(n_feat) + (long long)stage_states * n_mix * (2 * n_feat + 1));
}

// max that returns NaN if either input is NaN (torch.amax's rule)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

template <int M>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
gmm_emissions_kernel(const float* __restrict__ x, const float* __restrict__ means,
                     const float* __restrict__ log_var, const float* __restrict__ log_mix,
                     float* __restrict__ out, long long n_rows, int n_sets, int n_states,
                     int n_feat, int stage_states) {
  constexpr int ST = state_tile(M);       // states a register tile
  constexpr int REC = 2 * ST * M;         // floats a (tile, f): ST M means, ST M 1/var
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);       // [F][X_STRIDE]
  float* ps = xs + x_floats(n_feat);                 // [stage/ST][F][REC]
  float* cs = ps + stage_states * M * 2 * n_feat;    // [stage][M]

  const int tid = threadIdx.x;
  const int p = (int)(blockIdx.x % (unsigned)n_sets);
  const long long row0 = (long long)(blockIdx.x / (unsigned)n_sets) * ROWS;
  const long long left = n_rows - row0;
  const int rows_here = left < ROWS ? (int)left : ROWS;

  // the row tile, transposed: consecutive threads read consecutive floats
  // of the tile's contiguous [rows_here, F] chunk
  {
    const float* xt = x + row0 * n_feat;
    const int n_in = rows_here * n_feat;
    const int dr = THREADS / n_feat, df = THREADS % n_feat;
    int r = tid / n_feat, f = tid % n_feat;
    for (int i = tid; i < ROWS * n_feat; i += THREADS) {
      xs[f * X_STRIDE + r] = i < n_in ? xt[i] : 0.0f;
      r += dr;
      f += df;
      if (f >= n_feat) { f -= n_feat; ++r; }
    }
  }

  const long long set_gauss = (long long)p * n_states * M;   // the set's first Gaussian
  const bool vec_store = n_states % ST == 0;
  bool row_ok[RPT];
  float* out_row[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    row_ok[r] = tid + r * THREADS < rows_here;
    out_row[r] = out + ((row0 + tid + r * THREADS) * n_sets + p) * n_states;
  }

  for (int s0 = 0; s0 < n_states; s0 += stage_states) {
    const int n_stage = min(stage_states, n_states - s0);
    const int n_tiles = (n_stage + ST - 1) / ST;
    __syncthreads();                      // the previous stage's reads are done
    // means and 1/var of the stage: read in the source's (s, m, f) order
    {
      const float* mu = means + (set_gauss + (long long)s0 * M) * n_feat;
      const float* lv = log_var + (set_gauss + (long long)s0 * M) * n_feat;
      const int n_in = n_stage * M * n_feat;
      const int dg = THREADS / n_feat, df = THREADS % n_feat;
      int g = tid / n_feat, f = tid % n_feat;          // g = s M + m
      for (int i = tid; i < n_tiles * ST * M * n_feat; i += THREADS) {
        const int s = g / M, m = g - s * M;
        const int at = ((s / ST) * n_feat + f) * REC + (s % ST) * M + m;
        const bool in = i < n_in;
        ps[at] = in ? mu[i] : 0.0f;
        ps[at + ST * M] = in ? expf(-lv[i]) : 0.0f;
        g += dg;
        f += df;
        if (f >= n_feat) { f -= n_feat; ++g; }
      }
      // each Gaussian's constant, its log-variances summed in order over f
      for (int g2 = tid; g2 < n_tiles * ST * M; g2 += THREADS) {
        float c = 0.0f;
        if (g2 < n_stage * M) {
          const float* v = lv + (long long)g2 * n_feat;
          float sum = 0.0f;
          for (int f2 = 0; f2 < n_feat; ++f2) sum += v[f2];
          c = log_mix[set_gauss + (long long)s0 * M + g2] - 0.5f * (sum + n_feat * LOG_2PI);
        }
        cs[g2] = c;
      }
    }
    __syncthreads();

    for (int tile = 0; tile < n_tiles; ++tile) {
      float acc[RPT][ST][M];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int st = 0; st < ST; ++st)
#pragma unroll
          for (int m = 0; m < M; ++m) acc[r][st][m] = 0.0f;
      const float* xp = xs + tid;
      const float4* rec = reinterpret_cast<const float4*>(ps + tile * n_feat * REC);
#pragma unroll 4
      for (int f = 0; f < n_feat; ++f) {
        float xv[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) xv[r] = xp[f * X_STRIDE + r * THREADS];
        float pv[REC];
#pragma unroll
        for (int k = 0; k < REC / 4; ++k) {
          const float4 v = rec[f * (REC / 4) + k];
          pv[4 * k] = v.x;
          pv[4 * k + 1] = v.y;
          pv[4 * k + 2] = v.z;
          pv[4 * k + 3] = v.w;
        }
#pragma unroll
        for (int st = 0; st < ST; ++st)
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const float mu = pv[st * M + m], iv = pv[ST * M + st * M + m];
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
              const float d = xv[r] - mu;
              acc[r][st][m] = fmaf(d * d, iv, acc[r][st][m]);
            }
          }
      }
      // the log-sum-exp over the mixtures (torch.logsumexp: an infinite
      // max is taken out as 0, so all -inf gives -inf), then the stores
      const int s_base = s0 + tile * ST;
      const float* c = cs + tile * ST * M;
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float y[ST];
#pragma unroll
        for (int st = 0; st < ST; ++st) {
          float v[M];
#pragma unroll
          for (int m = 0; m < M; ++m) v[m] = fmaf(-0.5f, acc[r][st][m], c[st * M + m]);
          float mx = v[0];
#pragma unroll
          for (int m = 1; m < M; ++m) mx = max_nan(mx, v[m]);
          const float shift = fabsf(mx) == __int_as_float(0x7f800000) ? 0.0f : mx;
          float sum = 0.0f;
#pragma unroll
          for (int m = 0; m < M; ++m) sum += expf(v[m] - shift);
          y[st] = logf(sum) + shift;
        }
        if (!row_ok[r]) continue;
        if (vec_store) {
          float* dst = out_row[r] + s_base;
          if constexpr (ST == 4)
            *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
          else
            *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
        } else {
#pragma unroll
          for (int st = 0; st < ST; ++st)
            if (s_base + st < n_states) out_row[r][s_base + st] = y[st];
        }
      }
    }
  }
}

template <int M>
cudaError_t launch(const float* x, const float* means, const float* log_var,
                   const float* log_mix, float* out, long long n_rows, int n_sets,
                   int n_states, int n_feat, int stage_states, cudaStream_t stream) {
  const long long blocks = (n_rows + ROWS - 1) / ROWS * n_sets;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long smem = smem_bytes(M, n_feat, stage_states);
  if (smem > SMEM_OPTIN) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gmm_emissions_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gmm_emissions_kernel<M><<<(unsigned)blocks, THREADS, (size_t)smem, stream>>>(
      x, means, log_var, log_mix, out, n_rows, n_sets, n_states, n_feat, stage_states);
  return cudaGetLastError();
}

}  // namespace

// log_b [n_rows, n_sets, n_states] of rows x [n_rows, n_feat] against
// parameter sets means, log_var [n_sets, n_states, n_mix, n_feat] and
// log_mix [n_sets, n_states, n_mix], all float32 and contiguous.
// stage_states (a multiple of 4) states are staged at a time
// (kernels/gmm_emissions.py:stage_states).  1 <= n_mix <= 8,
// 1 <= n_feat <= 64, n_rows, n_sets, n_states >= 1.
extern "C" int gmm_emissions(const void* x, const void* means, const void* log_var,
                             const void* log_mix, void* out, long long n_rows, int n_sets,
                             int n_states, int n_mix, int n_feat, int stage_states,
                             void* stream) {
  if (n_rows < 1 || n_sets < 1 || n_states < 1 || n_mix < 1 || n_mix > MAX_MIX ||
      n_feat < 1 || n_feat > MAX_FEAT || stage_states < 4 || stage_states % 4 != 0)
    return (int)cudaErrorInvalidValue;
  using Fn = cudaError_t (*)(const float*, const float*, const float*, const float*, float*,
                             long long, int, int, int, int, cudaStream_t);
  static const Fn fns[MAX_MIX] = {launch<1>, launch<2>, launch<3>, launch<4>,
                                  launch<5>, launch<6>, launch<7>, launch<8>};
  return (int)fns[n_mix - 1]((const float*)x, (const float*)means, (const float*)log_var,
                             (const float*)log_mix, (float*)out, n_rows, n_sets, n_states,
                             n_feat, stage_states, (cudaStream_t)stream);
}
