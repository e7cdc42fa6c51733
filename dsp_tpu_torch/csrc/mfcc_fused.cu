// Fused MFCC front-end: pre-emphasised frames [N, L] -> cepstra [N, C].
//
// Replaces the TPU kernel dsp_tpu/kernels/mfcc_pallas.py
// (mfcc_frames_pallas / _mfcc_kernel).  Each block takes a tile of TM
// frames through the whole chain
//
//   window -> cos/sin DFT GEMMs [L, K] -> power / NFFT -> mel GEMM [K, M]
//   -> log(max(., log_floor)) -> DCT GEMM [M, C] -> lifter
//   (-> c0 = log(max(frame energy, log_floor)) when use_energy)
//
// with the same constant matrices as the plain version
// (dsp_tpu_torch/ops/frontend.py:make_matrices), unpadded: the TPU's lane
// padding of K, M and C is not carried over.  All products are SIMT fp32
// FMAs on shared-memory tiles, and the power spectrum and log-mel energies
// stay in shared memory; only frames in and cepstra out touch device
// memory.  No reduced precision anywhere: a bf16/TF32 DFT GEMM visibly
// corrupts the log-mel cepstra (dsp_tpu/kernels/mfcc_pallas.py).
//
// What bounds it on the H100: fp32 FMA issue and shared-memory loads.  The
// two DFT products are ~97% of the work (2 x 400 x 257 FMAs per frame,
// ~21 GFLOP for the 50,688 frames of a 256-utterance chunk) against ~84 MB
// of frames read.  Each warp owns 4 frames and each lane 9 DFT bins (a
// 288-bin pass), so every broadcast frame sample and every cos/sin value
// loaded from shared memory feeds several FMAs held in registers (72
// accumulators per thread).  The mel and DCT products are small and read
// their constants straight from the L1/L2-cached device copies.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;       // 8 warps
constexpr int ROWS_PER_WARP = 4;
constexpr int TM = 8 * ROWS_PER_WARP;  // frames per block
constexpr int KT = 16;             // samples per reduction tile
constexpr int NC = 9;              // bins per lane per pass
constexpr int PASS = 32 * NC;      // bins per pass

__global__ void __launch_bounds__(THREADS)
mfcc_fused_kernel(const float* __restrict__ frames, const float* __restrict__ window,
                  const float* __restrict__ dft_cos, const float* __restrict__ dft_sin,
                  const float* __restrict__ mel_fb_t, const float* __restrict__ dct_t,
                  const float* __restrict__ lifter, float* __restrict__ out, int n,
                  int l_dim, int k_dim, int m_dim, int c_dim, float n_fft,
                  float log_floor, int use_energy) {
  extern __shared__ float smem[];
  const int n_pass = (k_dim + PASS - 1) / PASS;
  const int pw_stride = n_pass * PASS + 1;  // odd: rows fall on other banks
  float* a_s = smem;                        // [TM, KT] windowed frames
  float* cos_s = a_s + TM * KT;             // [KT, PASS]
  float* sin_s = cos_s + KT * PASS;         // [KT, PASS]
  float* pw_s = sin_s + KT * PASS;          // [TM, pw_stride] power spectrum
  float* lm_s = pw_s + TM * pw_stride;      // [TM, m_dim] log-mel energies
  float* e_s = lm_s + TM * m_dim;           // [TM] frame energies

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n0 = blockIdx.x * TM;

  // ---- DFT power spectrum, one pass of PASS bins at a time -------------
  for (int p = 0; p < n_pass; ++p) {
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

size_t mfcc_fused_smem_bytes(int k_dim, int m_dim) {
  int n_pass = (k_dim + PASS - 1) / PASS;
  size_t floats = (size_t)TM * KT + 2 * (size_t)KT * PASS
                  + (size_t)TM * (n_pass * PASS + 1) + (size_t)TM * m_dim + TM;
  return floats * sizeof(float);
}

}  // namespace

extern "C" int mfcc_fused(const void* frames, const void* window, const void* dft_cos,
                          const void* dft_sin, const void* mel_fb_t, const void* dct_t,
                          const void* lifter, void* out, int n, int l_dim, int k_dim,
                          int m_dim, int c_dim, float n_fft, float log_floor,
                          int use_energy, void* stream) {
  size_t smem = mfcc_fused_smem_bytes(k_dim, m_dim);
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (n + TM - 1) / TM;
  mfcc_fused_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)frames, (const float*)window, (const float*)dft_cos,
      (const float*)dft_sin, (const float*)mel_fb_t, (const float*)dct_t,
      (const float*)lifter, (float*)out, n, l_dim, k_dim, m_dim, c_dim, n_fft,
      log_floor, use_energy);
  return (int)cudaGetLastError();
}
