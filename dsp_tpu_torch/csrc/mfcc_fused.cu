// Fused MFCC front-end: pre-emphasised frames [N, L] -> cepstra [N, C].
//
// Replaces the TPU kernel dsp_tpu/kernels/mfcc_pallas.py:97
// mfcc_frames_pallas (its pallas_call at :123, body _mfcc_kernel at
// :68-94).  The function is the TPU kernel's:
//
//   window -> power |sum_n w[n] x[n] e^{-2 pi i n k / NFFT}|^2 / NFFT,
//   k <= NFFT/2 -> mel [K, M] -> log(max(., log_floor)) -> DCT [M, C]
//   -> lifter (-> c0 = log(max(sum x^2, log_floor)) when use_energy)
//
// with the plain version's constants (ops/frontend.py:make_matrices).
// Where L > NFFT the TPU kernel's DFT matrix cos/sin(2 pi n k / NFFT),
// n < L, aliases sample n onto n mod NFFT, so both modes fold; where
// L < NFFT the missing samples are zeros.  No reduced precision anywhere:
// a bf16/TF32 DFT GEMM visibly corrupts the log-mel cepstra.  The host
// picks the mode (kernels/mfcc_fused.py:launch_plan) and one C entry,
// mfcc_fused, launches the mode's __global__.
//
// FFT mode (NFFT a power of two, at least 4): one warp a frame, a few
// frames a warp in turn.  The chain costs ~16 K flops a frame (a real FFT
// of 512 points is ~13 K; each bin feeds at most two triangular mel
// filters; the DCT is 26 x 13), so the mode is bound by bytes: the frames
// read once and the cepstra written once, ~84 MB for the 50,688 frames of
// a 256-utterance chunk.  So:
//   * a warp reads its frame once, coalesced, 16 B a lane where the row is
//     16-B aligned, windows it in registers, sums x^2 in the same pass and
//     folds it modulo NFFT into registers before one store to shared memory;
//   * the NFFT real points are an NFFT/2-point complex FFT (even samples
//     real, odd imaginary) in the warp's shared buffer, input in
//     bit-reversed order, decimation in time in radix-4 steps (two radix-2
//     stages in registers; one radix-2 stage first where the count is
//     odd), __syncwarp between steps and no block barrier; one pad word
//     every 32 keeps the bit-reversed store and the short-stride
//     butterflies off shared bank conflicts;
//   * twiddles come from a table the host builds in float64
//     (fft_twiddles), no sin/cos on the card; each block restages it once
//     stage by stage, so a stage's lanes read neighbouring words;
//   * each mel filter sums only its nonzero bins (mel_pack), then log, DCT
//     and lifter; window, twiddles, mel weights, DCT and lifter are staged
//     once a block in shared memory;
//   * only [N, C] is written to device memory.
//
// Folded NFFT (NFFT < L), either mode: each point of the transform sums
// ceil(L / NFFT) windowed samples, and the quietest mel bands of speech
// frames, ~1e-7 of a frame's energy, sink to float32 rounding in the fold
// and the transform.  There a warp takes a frame at a time: it folds the
// frame against the host's float64 window into a float64 buffer in shared
// memory, then each lane takes bins of one period's DFT in float64 against
// the host's float64 table e^{-2 pi i m / NFFT} (fold_twiddles), and only the
// power returns to float32 for the mode's mel, log and DCT.  ~NFFT x K
// double FMAs a frame (2 K at NFFT = 64): small beside the frame's read.
// The plain version does the same in float64 (ops/frontend.py:power_spectrum).
//
// GEMM mode (any other NFFT): the first design, kept for NFFT that is not
// a power of two.  The DFT as two GEMMs, 2 x L x K FMAs a frame (~97% of
// 21 GFLOP at L = 400, K = 257 over 50,688 frames), SIMT fp32 on shared
// tiles: each warp owns 4 frames and each lane 9 bins (a 288-bin pass).
// Bound by operations on paper; in practice by its shared-memory loads
// (22 LDS to 72 FMAs a sample step) and the per-block restaging of the
// cos/sin pair from L2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;       // 8 warps
constexpr int ROWS_PER_WARP = 4;
constexpr int TM = 8 * ROWS_PER_WARP;  // frames per block
constexpr int KT = 16;             // samples per reduction tile
constexpr int NC = 9;              // bins per lane per pass
constexpr int PASS = 32 * NC;      // bins per pass

// A warp's folded power spectrum of one frame x [L] (NFFT < L, header):
// buf [NFFT] float64 scratch of this warp, pw [K] the power out.  Returns
// this lane's share of sum x^2.  Called by whole warps.
__device__ float folded_power(const float* __restrict__ x, const double* __restrict__ win64,
                              const double2* __restrict__ tw64, double* buf,
                              float* pw, int l_dim, int n_fft, int k_dim, int lane) {
  float energy = 0.f;
  for (int i = lane; i < n_fft; i += 32) {
    double acc = 0.0;
    for (int s = i; s < l_dim; s += n_fft) {
      const float v = x[s];
      energy = fmaf(v, v, energy);
      acc = fma((double)v, __ldg(win64 + s), acc);
    }
    buf[i] = acc;
  }
  __syncwarp();
  for (int k = lane; k < k_dim; k += 32) {
    double re = 0.0, im = 0.0;
    int m = 0;                                    // (j k) mod NFFT
    for (int j = 0; j < n_fft; ++j) {
      const double2 w = __ldg(tw64 + m);
      re = fma(buf[j], w.x, re);
      im = fma(buf[j], w.y, im);
      m += k;
      if (m >= n_fft) m -= n_fft;
    }
    pw[k] = (float)((re * re + im * im) / n_fft);
  }
  __syncwarp();
  return energy;
}

__global__ void __launch_bounds__(THREADS)
mfcc_fused_kernel(const float* __restrict__ frames, const float* __restrict__ window,
                  const float* __restrict__ dft_cos, const float* __restrict__ dft_sin,
                  const float* __restrict__ mel_fb_t, const float* __restrict__ dct_t,
                  const float* __restrict__ lifter, const double* __restrict__ win64,
                  const double2* __restrict__ tw64, float* __restrict__ out, int n,
                  int l_dim, int k_dim, int m_dim, int c_dim, float n_fft, int fold_n,
                  float log_floor, int use_energy) {
  extern __shared__ __align__(16) float smem[];
  const int n_pass = (k_dim + PASS - 1) / PASS;
  const int pw_stride = n_pass * PASS + 1;  // odd: rows fall on other banks
  double* fold_s = reinterpret_cast<double*>(smem);   // [8 warps, fold_n] if folded
  float* a_s = smem + 2 * fold_n * (THREADS / 32);    // [TM, KT] windowed frames
  float* cos_s = a_s + TM * KT;             // [KT, PASS]
  float* sin_s = cos_s + KT * PASS;         // [KT, PASS]
  float* pw_s = sin_s + KT * PASS;          // [TM, pw_stride] power spectrum
  float* lm_s = pw_s + TM * pw_stride;      // [TM, m_dim] log-mel energies
  float* e_s = lm_s + TM * m_dim;           // [TM] frame energies

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * TM;

  // ---- folded NFFT: each warp's rows in float64 (header) --------------
  if (fold_n > 0) {
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int lr = warp * ROWS_PER_WARP + r;
      if (n0 + lr < n)                        // the same for the whole warp
        folded_power(frames + (size_t)(n0 + lr) * l_dim, win64, tw64,
                     fold_s + (size_t)warp * fold_n, pw_s + lr * pw_stride, l_dim,
                     fold_n, k_dim, lane);
    }
  }

  // ---- DFT power spectrum, one pass of PASS bins at a time -------------
  for (int p = 0; fold_n == 0 && p < n_pass; ++p) {
    const int col0 = p * PASS;
    float re[ROWS_PER_WARP][NC], im[ROWS_PER_WARP][NC];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) re[r][c] = im[r][c] = 0.f;

    for (int k0 = 0; k0 < l_dim; k0 += KT) {
      for (int idx = tid; idx < TM * KT; idx += THREADS) {
        int r = idx / KT, kk = idx % KT;
        int row = n0 + r, s = k0 + kk;
        a_s[idx] = (row < n && s < l_dim)
                       ? frames[(size_t)row * l_dim + s] * window[s] : 0.f;
      }
      for (int idx = tid; idx < KT * PASS; idx += THREADS) {
        int kk = idx / PASS, c = idx % PASS;
        int s = k0 + kk, col = col0 + c;
        bool in = s < l_dim && col < k_dim;
        cos_s[idx] = in ? dft_cos[(size_t)s * k_dim + col] : 0.f;
        sin_s[idx] = in ? dft_sin[(size_t)s * k_dim + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        float av[ROWS_PER_WARP];
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r)
          av[r] = a_s[(warp * ROWS_PER_WARP + r) * KT + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float cv = cos_s[kk * PASS + lane + 32 * c];
          float sv = sin_s[kk * PASS + lane + 32 * c];
#pragma unroll
          for (int r = 0; r < ROWS_PER_WARP; ++r) {
            re[r][c] = fmaf(av[r], cv, re[r][c]);
            im[r][c] = fmaf(av[r], sv, im[r][c]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        int col = col0 + lane + 32 * c;
        if (col < k_dim)
          pw_s[(warp * ROWS_PER_WARP + r) * pw_stride + col] =
              (re[r][c] * re[r][c] + im[r][c] * im[r][c]) / n_fft;
      }
  }

  // ---- frame energies (raw pre-emphasised frames) for use_energy --------
  if (use_energy) {
    for (int r = warp * ROWS_PER_WARP; r < (warp + 1) * ROWS_PER_WARP; ++r) {
      float acc = 0.f;
      int row = n0 + r;
      if (row < n)
        for (int s = lane; s < l_dim; s += 32) {
          float v = frames[(size_t)row * l_dim + s];
          acc = fmaf(v, v, acc);
        }
      for (int o = 16; o > 0; o /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) e_s[r] = acc;
    }
  }
  __syncthreads();

  // ---- mel filterbank + floored log -------------------------------------
  for (int idx = tid; idx < TM * m_dim; idx += THREADS) {
    int r = idx / m_dim, m = idx % m_dim;
    const float* pw = pw_s + r * pw_stride;
    float acc = 0.f;
    for (int kb = 0; kb < k_dim; ++kb) acc = fmaf(pw[kb], __ldg(mel_fb_t + kb * m_dim + m), acc);
    lm_s[idx] = logf(fmaxf(acc, log_floor));
  }
  __syncthreads();

  // ---- DCT + lifter (+ energy coefficient) -------------------------------
  for (int idx = tid; idx < TM * c_dim; idx += THREADS) {
    int r = idx / c_dim, c = idx % c_dim;
    int row = n0 + r;
    if (row >= n) continue;
    float val;
    if (use_energy && c == 0) {
      val = logf(fmaxf(e_s[r], log_floor));
    } else {
      const float* lm = lm_s + r * m_dim;
      float acc = 0.f;
      for (int m = 0; m < m_dim; ++m) acc = fmaf(lm[m], __ldg(dct_t + m * c_dim + c), acc);
      val = acc * lifter[c];
    }
    out[(size_t)row * c_dim + c] = val;
  }
}

size_t mfcc_fused_smem_bytes(int k_dim, int m_dim, int fold_n) {
  int n_pass = (k_dim + PASS - 1) / PASS;
  size_t floats = (size_t)TM * KT + 2 * (size_t)KT * PASS
                  + (size_t)TM * (n_pass * PASS + 1) + (size_t)TM * m_dim + TM;
  return floats * sizeof(float) + sizeof(double) * (size_t)fold_n * (THREADS / 32);
}

// ---------------------------------------------------------------- FFT mode
constexpr int FFT_MAX_WARPS = 8;

__host__ __device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__host__ __device__ inline int round_up4(int v) { return (v + 3) & ~3; }

// Shared floats of the FFT mode: block constants, then per warp the padded
// re/im buffers, the power spectrum and the log-mel energies.
__host__ __device__ inline size_t mfcc_fft_block_floats(int half, int l_dim, int m_dim,
                                                        int c_dim, int n_mel_w) {
  return 4 * (size_t)half + round_up4(l_dim) + (size_t)m_dim * c_dim + c_dim + n_mel_w
         + 3 * (size_t)m_dim;
}

__host__ __device__ inline size_t mfcc_fft_warp_floats(int half, int m_dim) {
  return 2 * (size_t)padded(half) + half + 1 + m_dim;
}

__global__ void __launch_bounds__(32 * FFT_MAX_WARPS)
mfcc_fft_kernel(const float* __restrict__ frames, const float* __restrict__ window,
                const float2* __restrict__ twiddles, const int* __restrict__ mel_rng,
                const float* __restrict__ mel_w, const float* __restrict__ dct_t,
                const float* __restrict__ lifter, const double* __restrict__ win64,
                const double2* __restrict__ tw64, float* __restrict__ out, int n,
                int l_dim, int log_half, int m_dim, int c_dim, int n_mel_w,
                float log_floor, int use_energy, int frames_per_warp) {
  extern __shared__ __align__(16) float smem[];
  const int half = 1 << log_half;          // complex points: NFFT / 2
  const int n_fft = 2 * half;
  const bool folded = n_fft < l_dim;
  const int l4 = round_up4(l_dim);
  const int warps = blockDim.x >> 5;
  // [warps, NFFT] float64 where folded (a multiple of 32 bytes: the float4
  // alignment of what follows holds)
  double* fold_s = reinterpret_cast<double*>(smem);
  float* blk_s = smem + (folded ? 2 * n_fft * warps : 0);
  float2* tw_s = reinterpret_cast<float2*>(blk_s);  // [half] e^{-2 pi i k / NFFT}
  // [half] per stage: stage h's W_{2h}^p, p < h, at h - 1 + p, so that a
  // stage's lanes read neighbouring words (one slot of padding at the end)
  float2* st_s = tw_s + half;
  float* win_s = blk_s + 4 * half;                   // [l4], zeros past L
  float* dct_s = win_s + l4;                         // [M, C]
  float* lift_s = dct_s + m_dim * c_dim;             // [C]
  float* melw_s = lift_s + c_dim;                    // [n_mel_w]
  int* melr_s = reinterpret_cast<int*>(melw_s + n_mel_w);   // [M, 3]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hp = padded(half);
  float* re_s = reinterpret_cast<float*>(melr_s + 3 * m_dim)
                + warp * mfcc_fft_warp_floats(half, m_dim);
  float* im_s = re_s + hp;
  float* pw_s = im_s + hp;                           // [half + 1]
  float* lm_s = pw_s + half + 1;                     // [M]

  for (int i = tid; i < half; i += blockDim.x) tw_s[i] = twiddles[i];
  for (int i = tid; i < half - 1; i += blockDim.x) {
    const int h = 1 << (31 - __clz(i + 1)), p = i + 1 - h;
    st_s[i] = twiddles[p * (half / h)];           // W_{2h}^p = W_NFFT^{p half / h}
  }
  for (int i = tid; i < l4; i += blockDim.x) win_s[i] = i < l_dim ? window[i] : 0.f;
  for (int i = tid; i < m_dim * c_dim; i += blockDim.x) dct_s[i] = dct_t[i];
  for (int i = tid; i < c_dim; i += blockDim.x) lift_s[i] = lifter[i];
  for (int i = tid; i < n_mel_w; i += blockDim.x) melw_s[i] = mel_w[i];
  for (int i = tid; i < 3 * m_dim; i += blockDim.x) melr_s[i] = mel_rng[i];
  __syncthreads();

  const bool vec = (l_dim & 3) == 0 && (reinterpret_cast<size_t>(frames) & 15) == 0;
  const int shift = 32 - log_half;
  const float inv_n = 1.f / (float)n_fft;   // a power of two: exact
  const int base = blockIdx.x * warps * frames_per_warp;
  for (int f = 0; f < frames_per_warp; ++f) {
    const int row = base + f * warps + warp;
    if (row >= n) break;                      // the same for the whole warp
    const float* x = frames + (size_t)row * l_dim;

    float energy = 0.f;
    if (folded) {
      energy = folded_power(x, win64, tw64, fold_s + (size_t)warp * n_fft, pw_s, l_dim,
                            n_fft, half + 1, lane);
    } else {
      // ---- read, window, fold modulo NFFT: lane owns points 4g..4g+3 -----
      for (int g = lane; g < half / 2; g += 32) {
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int s = 4 * g; s < l_dim; s += n_fft) {
          float4 v;
          if (vec) {
            v = __ldg(reinterpret_cast<const float4*>(x + s));
          } else {
            v.x = x[s];
            v.y = s + 1 < l_dim ? x[s + 1] : 0.f;
            v.z = s + 2 < l_dim ? x[s + 2] : 0.f;
            v.w = s + 3 < l_dim ? x[s + 3] : 0.f;
          }
          const float4 w = *reinterpret_cast<const float4*>(win_s + s);
          energy = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, energy))));
          a0 = fmaf(v.x, w.x, a0);
          a1 = fmaf(v.y, w.y, a1);
          a2 = fmaf(v.z, w.z, a2);
          a3 = fmaf(v.w, w.w, a3);
        }
        // z[m] = x[2m] + i x[2m+1], stored at bit-reversed m
        const int m0 = padded(__brev(2 * g) >> shift), m1 = padded(__brev(2 * g + 1) >> shift);
        re_s[m0] = a0;
        im_s[m0] = a1;
        re_s[m1] = a2;
        im_s[m1] = a3;
      }
      __syncwarp();

      // ---- decimation in time over the half-length complex FFT: a radix-2
      // stage where the stage count is odd, then radix 4 (two stages in
      // registers, h and 2h, one load and one store of each point) -------
      int h = 1;
      if (log_half & 1) {
        for (int b = lane; b < half / 2; b += 32) {     // h = 1: twiddle 1
          const int i0 = padded(2 * b), i1 = padded(2 * b + 1);
          const float ar = re_s[i0], ai = im_s[i0], br = re_s[i1], bi = im_s[i1];
          re_s[i0] = ar + br;
          im_s[i0] = ai + bi;
          re_s[i1] = ar - br;
          im_s[i1] = ai - bi;
        }
        h = 2;
        __syncwarp();
      }
      for (; h < half; h <<= 2) {
        for (int b = lane; b < half / 4; b += 32) {
          const int p = b & (h - 1);
          const int j0 = ((b - p) << 2) + p;
          const int i0 = padded(j0), i1 = padded(j0 + h), i2 = padded(j0 + 2 * h),
                    i3 = padded(j0 + 3 * h);
          const float2 w1 = st_s[h - 1 + p];           // W_{2h}^p
          const float2 w2 = st_s[2 * h - 1 + p];       // W_{4h}^p; W_{4h}^{p+h} = -i w2
          float a0r = re_s[i0], a0i = im_s[i0], a1r = re_s[i1], a1i = im_s[i1];
          float a2r = re_s[i2], a2i = im_s[i2], a3r = re_s[i3], a3i = im_s[i3];
          float tr = a1r * w1.x - a1i * w1.y, ti = a1r * w1.y + a1i * w1.x;
          a1r = a0r - tr; a1i = a0i - ti; a0r += tr; a0i += ti;
          tr = a3r * w1.x - a3i * w1.y; ti = a3r * w1.y + a3i * w1.x;
          a3r = a2r - tr; a3i = a2i - ti; a2r += tr; a2i += ti;
          tr = a2r * w2.x - a2i * w2.y; ti = a2r * w2.y + a2i * w2.x;
          re_s[i0] = a0r + tr; im_s[i0] = a0i + ti;
          re_s[i2] = a0r - tr; im_s[i2] = a0i - ti;
          const float w3x = w2.y, w3y = -w2.x;
          tr = a3r * w3x - a3i * w3y; ti = a3r * w3y + a3i * w3x;
          re_s[i1] = a1r + tr; im_s[i1] = a1i + ti;
          re_s[i3] = a1r - tr; im_s[i3] = a1i - ti;
        }
        __syncwarp();
      }

      // ---- real split: X[k] = E[k] + W^k O[k], k = 0 .. half ---------------
      for (int k = lane; k <= half; k += 32) {
        const int k1 = padded(k & (half - 1)), k2 = padded((half - k) & (half - 1));
        const float zr = re_s[k1], zi = im_s[k1];
        const float cr = re_s[k2], ci = -im_s[k2];        // conj(Z[half - k])
        const float er = 0.5f * (zr + cr), ei = 0.5f * (zi + ci);
        const float orr = 0.5f * (zi - ci), oi = -0.5f * (zr - cr);   // (Z - Zc) / 2i
        const float2 w = k < half ? tw_s[k] : make_float2(-1.f, 0.f);
        const float xr = er + (orr * w.x - oi * w.y), xi = ei + (orr * w.y + oi * w.x);
        pw_s[k] = (xr * xr + xi * xi) * inv_n;
      }
      __syncwarp();
    }

    // ---- mel over each filter's nonzero bins, floored log ---------------
    for (int m = lane; m < m_dim; m += 32) {
      const int lo = melr_s[3 * m], cnt = melr_s[3 * m + 1], off = melr_s[3 * m + 2];
      float acc = 0.f;
      for (int j = 0; j < cnt; ++j) acc = fmaf(pw_s[lo + j], melw_s[off + j], acc);
      lm_s[m] = logf(fmaxf(acc, log_floor));
    }
    if (use_energy)
      for (int o = 16; o > 0; o >>= 1) energy += __shfl_xor_sync(0xffffffffu, energy, o);
    __syncwarp();

    // ---- DCT + lifter (+ energy coefficient) -----------------------------
    for (int c = lane; c < c_dim; c += 32) {
      float val;
      if (use_energy && c == 0) {
        val = logf(fmaxf(energy, log_floor));
      } else {
        float acc = 0.f;
        for (int m = 0; m < m_dim; ++m) acc = fmaf(lm_s[m], dct_s[m * c_dim + c], acc);
        val = acc * lift_s[c];
      }
      out[(size_t)row * c_dim + c] = val;
    }
    __syncwarp();                             // buffers are reused by the next frame
  }
}

}  // namespace

// mode 0: GEMM (any NFFT), 1: FFT (NFFT a power of two, at least 4).  The
// host's plan (kernels/mfcc_fused.py:launch_plan) gives warps, frames a
// warp and the shared bytes; the entry refuses a plan whose bytes differ
// from its own count.  window64 [L] and twiddles64 [NFFT] (float64) are read
// where NFFT < L (the folded path).  Pointers a mode does not read may be
// null.
extern "C" int mfcc_fused(const void* frames, const void* window, const void* dft_cos,
                          const void* dft_sin, const void* twiddles, const void* mel_rng,
                          const void* mel_w, const void* mel_fb_t, const void* dct_t,
                          const void* lifter, const void* window64, const void* twiddles64,
                          void* out, int n, int l_dim, int n_fft,
                          int m_dim, int c_dim, int n_mel_w, float log_floor,
                          int use_energy, int mode, int warps, int frames_per_warp,
                          int smem_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int k_dim = n_fft / 2 + 1;
  int fold_n = n_fft < l_dim ? n_fft : 0;
  if (fold_n > 0 && (window64 == nullptr || twiddles64 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode == 0) {
    size_t smem = mfcc_fused_smem_bytes(k_dim, m_dim, fold_n);
    if ((size_t)smem_bytes != smem || warps != THREADS / 32 || frames_per_warp != ROWS_PER_WARP)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        mfcc_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int blocks = (n + TM - 1) / TM;
    mfcc_fused_kernel<<<blocks, THREADS, smem, st>>>(
        (const float*)frames, (const float*)window, (const float*)dft_cos,
        (const float*)dft_sin, (const float*)mel_fb_t, (const float*)dct_t,
        (const float*)lifter, (const double*)window64, (const double2*)twiddles64,
        (float*)out, n, l_dim, k_dim, m_dim, c_dim, (float)n_fft, fold_n,
        log_floor, use_energy);
    return (int)cudaGetLastError();
  }
  if (mode != 1 || n_fft < 4 || (n_fft & (n_fft - 1)) != 0 || warps < 1
      || warps > FFT_MAX_WARPS || frames_per_warp < 1)
    return (int)cudaErrorInvalidValue;
  int half = n_fft / 2, log_half = 0;
  while ((1 << log_half) < half) ++log_half;
  size_t smem = sizeof(float) * (mfcc_fft_block_floats(half, l_dim, m_dim, c_dim, n_mel_w)
                                 + warps * mfcc_fft_warp_floats(half, m_dim))
                + sizeof(double) * (size_t)fold_n * warps;
  if ((size_t)smem_bytes != smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  long long per_block = (long long)warps * frames_per_warp;
  int blocks = (int)((n + per_block - 1) / per_block);
  mfcc_fft_kernel<<<blocks, 32 * warps, smem, st>>>(
      (const float*)frames, (const float*)window, (const float2*)twiddles,
      (const int*)mel_rng, (const float*)mel_w, (const float*)dct_t, (const float*)lifter,
      (const double*)window64, (const double2*)twiddles64, (float*)out, n, l_dim,
      log_half, m_dim, c_dim, n_mel_w, log_floor, use_energy, frames_per_warp);
  return (int)cudaGetLastError();
}
