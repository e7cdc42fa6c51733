// Viterbi best-path scores of a batch of HMM lattices, one lane a state.
//
// Replaces no TPU kernel: the JAX package decodes with a lax.scan
// (dsp_tpu/ops/viterbi.py:viterbi_score) that XLA compiles, and the port's
// plain version is the same recursion as a Python loop of small ops
// (ops/viterbi.py:_viterbi_loop), replayed on the card as a CUDA graph.
// It was added because that loop is ~5 launches a frame, each writing and
// reading a [pairs, S, S] tensor (11.5 MB at 1,024 x 11 pairs of 16
// states), where the state is [pairs, S].  For every (utterance, word)
// pair p, with d the log-deltas over its S states:
//
//   d_0[s]  = log_pi[s] + log_b[0, s]
//   d_t[s]  = max_j (d_{t-1}[j] + log_a[j, s]) + log_b[t, s]   for t < len
//   d_t     = d_{t-1}                                          for t >= len
//   out[p]  = max_s d_{T-1}[s]
//
// Each sum is one fp32 add (no FMA can form: there is no product) and each
// max is exact in any order, so the scores equal the loop's bit for bit,
// NEG_INF = -1e30 sums of unreachable states included; a NaN propagates
// through every max, as torch.amax propagates it (PTX max.NaN).
//
// What bounds it on the H100: device memory, then the shuffles and the
// dependent steps.  The emissions log_b are read once: T x pairs x S x 4
// bytes, 142.7 MB at the main shape (198 frames, 1,024 x 11 pairs, 16
// states), 0.043 ms at 3.35 TB/s.  The dense max costs S shuffles, S
// adds and S maxes a lane and frame: 197 x 11,264 pairs x 16 x 16 x 3 =
// 1.7 G lane operations, 17.8 M warp shuffles, ~0.07 ms at one shuffle a
// cycle an SM.  Measured (H100 80GB HBM3, 700 W): 0.180 ms at the main
// shape, 4.2x the bytes bound; 0.045 ms at 128 x 11 pairs, where the
// card is far from full and each warp's 197 dependent steps set the time.
//
// Design.  A pair takes G lanes, G the next power of two >= S (16 lanes at
// S = 16: two pairs a warp); lane s holds d[s] and column s of log_a in
// registers.  A step fetches d[j] from lane j of the group by __shfl_sync
// (width G), takes the max over j of d[j] + log_a[j, s] in four running
// maxes, and adds log_b[t, s].  No shared memory and no block barrier: a warp's
// groups exchange nothing.  A warp steps to its longest pair's length;
// past its own length a pair keeps d (the loop's `where`).  log_b is read
// in place through its strides (score_words' [T, B, W, S] view of a
// [B, T, W, S] tensor: a warp's two pairs read 128 contiguous bytes a
// frame) and PREFETCH frames ahead into registers, so the dependent chain
// does not wait on memory.  log_a stays dense, not left-to-right only: at
// S = 16 the dense max is ~0.05 ms a request, and it is exact for every
// topology.  A 1-D grid over warps: no 65,535-row limit; T has none
// either, as log_b is streamed.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BLOCK = 128;      // threads a block: 4 warps
constexpr int PREFETCH = 8;     // frames of log_b in flight a lane

// Element strides of the inputs, broadcast to [n0, n1] pairs (0 where a
// tensor broadcasts along that dim).
struct Strides {
  long long pi0, pi1, pis;          // log_pi [n0, n1, S]
  long long a0, a1, aj, as;         // log_a  [n0, n1, S (from), S (to)]
  long long bt, b0, b1, bs;         // log_b  [T, n0, n1, S]
  long long l0, l1;                 // length [n0, n1]
};
constexpr int N_STRIDES = sizeof(Strides) / sizeof(long long);

// max that returns NaN if either input is NaN (torch.amax's rule)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// length_kind: 0 none (every pair T frames), 1 int32, 2 int64
template <int G>
__global__ void __launch_bounds__(BLOCK)
viterbi_score_kernel(const float* __restrict__ log_pi, const float* __restrict__ log_a,
                     const float* __restrict__ log_b, const void* __restrict__ length,
                     int length_kind, float* __restrict__ out, long long n_pairs,
                     long long n1, int t_len, int n_states, Strides st) {
  constexpr int PAIRS = 32 / G;       // pairs a warp
  const int lane = threadIdx.x & 31;
  const int s = lane % G;             // this lane's state
  const long long warp = ((long long)blockIdx.x * BLOCK + threadIdx.x) >> 5;
  if (warp * PAIRS >= n_pairs) return;            // the whole warp: uniform
  const long long p = warp * PAIRS + lane / G;
  const bool pair_ok = p < n_pairs;
  const bool live = pair_ok && s < n_states;
  const long long q0 = pair_ok ? p / n1 : 0, q1 = pair_ok ? p % n1 : 0;

  int n = pair_ok ? t_len : 1;        // frames this pair steps through
  if (pair_ok && length_kind) {
    const long long at = q0 * st.l0 + q1 * st.l1;
    const long long len = length_kind == 1 ? (long long)((const int*)length)[at]
                                           : ((const long long*)length)[at];
    n = len >= t_len ? t_len : (len < 1 ? 1 : (int)len);
  }
  int n_warp = n;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n_warp = max(n_warp, __shfl_xor_sync(FULL, n_warp, off));

  // column s of log_a; rows past S are never read
  float col[G];
  const float* a = log_a + q0 * st.a0 + q1 * st.a1 + s * st.as;
#pragma unroll
  for (int j = 0; j < G; ++j) col[j] = (live && j < n_states) ? a[j * st.aj] : 0.0f;
  const float* b = log_b + q0 * st.b0 + q1 * st.b1 + s * st.bs;
  float d = live ? log_pi[q0 * st.pi0 + q1 * st.pi1 + s * st.pis] + b[0] : 0.0f;

  float next[PREFETCH];               // log_b of frames t .. t + PREFETCH - 1
#pragma unroll
  for (int k = 0; k < PREFETCH; ++k)
    next[k] = (live && 1 + k < n) ? b[(long long)(1 + k) * st.bt] : 0.0f;
  for (int t0 = 1; t0 < n_warp; t0 += PREFETCH) {
#pragma unroll
    for (int k = 0; k < PREFETCH; ++k) {
      const int t = t0 + k;
      if (t >= n_warp) break;                     // uniform across the warp
      const float emit = next[k];
      const int ahead = t + PREFETCH;
      next[k] = (live && ahead < n) ? b[(long long)ahead * st.bt] : 0.0f;
      // the max over j in four running maxes, each started at the j = 0
      // term.  Every lane shuffles every j < G and a term past S is
      // selected away: a branch a term waited out each shuffle's latency
      // in turn (0.110 ms against 0.045 at 128 x 11 pairs of 16 states).
      const float first = __shfl_sync(FULL, d, 0, G) + col[0];
      float m[4] = {first, first, first, first};
#pragma unroll
      for (int j = 1; j < G; ++j) {
        const float term = __shfl_sync(FULL, d, j, G) + col[j];
        m[j & 3] = j < n_states ? max_nan(m[j & 3], term) : m[j & 3];
      }
      if (t < n) d = max_nan(max_nan(m[0], m[1]), max_nan(m[2], m[3])) + emit;
    }
  }
  // the best final state: -inf (max's identity) on lanes past S
  float r = live ? d : -__int_as_float(0x7f800000);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) r = max_nan(r, __shfl_xor_sync(FULL, r, off, G));
  if (pair_ok && s == 0) out[p] = r;
}

template <int G>
cudaError_t launch(const float* pi, const float* a, const float* b, const void* len,
                   int len_kind, float* out, long long n_pairs, long long n1, int t_len,
                   int n_states, const Strides& st, cudaStream_t stream) {
  const long long warps = (n_pairs + 32 / G - 1) / (32 / G);
  const long long blocks = (warps * 32 + BLOCK - 1) / BLOCK;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  viterbi_score_kernel<G><<<(unsigned)blocks, BLOCK, 0, stream>>>(
      pi, a, b, len, len_kind, out, n_pairs, n1, t_len, n_states, st);
  return cudaGetLastError();
}

}  // namespace

// Best-path log-likelihood of n_pairs = n0 x n1 lattices into out [n_pairs]
// (row-major over (n0, n1)).  `strides` holds the N_STRIDES element
// strides of struct Strides, in its order.  1 <= n_states <= 32, t_len >= 1.
extern "C" int viterbi_score(const void* log_pi, const void* log_a, const void* log_b,
                             const void* length, int length_kind, void* out,
                             long long n_pairs, long long n1, int t_len, int n_states,
                             const long long* strides, void* stream) {
  if (n_states < 1 || n_states > 32 || t_len < 1 || n_pairs < 1 || n1 < 1 ||
      length_kind < 0 || length_kind > 2 || (length_kind && !length))
    return (int)cudaErrorInvalidValue;
  Strides st;
  long long* fields = reinterpret_cast<long long*>(&st);
  for (int i = 0; i < N_STRIDES; ++i) fields[i] = strides[i];
  const auto fn = n_states <= 1 ? launch<1> : n_states <= 2 ? launch<2>
                : n_states <= 4 ? launch<4> : n_states <= 8 ? launch<8>
                : n_states <= 16 ? launch<16> : launch<32>;
  return (int)fn((const float*)log_pi, (const float*)log_a, (const float*)log_b, length,
                 length_kind, (float*)out, n_pairs, n1, t_len, n_states, st,
                 (cudaStream_t)stream);
}
