// All-pairs subsequence DTW (keyword spotting), one thread block per
// (stream, template) pair.
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
// Design.  Thread i owns template row i and keeps that row's features and
// |a|^2 in registers for the whole walk.  The block walks anti-diagonals
// d = i + j; on each, thread i computes cell (i, d - i).  Its horizontal
// predecessor is its own previous cell (registers), its vertical one is
// thread i-1's cell of the previous diagonal (a double-buffered row of D
// and s in shared memory, one barrier per diagonal), and its diagonal one
// is the vertical it read one diagonal earlier (registers).  Stream frames
// enter a ring of `ring` >= T + 32 frames in shared memory, 32 at a time,
// with their |b|^2.  So the state is O(T) and does not grow with the
// stream: any stream length runs.  The TPU kernel's [ST, T, U] cost
// scratch, its Kogge-Stone cummins over 128-lane rows and its [K, B, U]
// output layout (Mosaic tiling) are not carried over.
//
// What bounds it on the H100.  fp32 SIMT operations: each of the
// sum(tl * sl) cells costs a 39-long dot product (~2F+3 flops with the DP),
// about 0.3-0.9 ms of the 67 TFLOP/s fp32 peak at the bench_all spotting
// shape (64 streams of 598 frames x 100 templates of 198 frames, F = 39),
// while the [B,K,U] outputs (~31 MB) cost ~9 us at 3.35 TB/s.  In this
// design the floor is higher: every cell reads its stream frame from
// shared memory (F loads per F FMAs, lanes of a warp reading different
// frames), so the shared-memory load rate, and the per-diagonal barrier,
// bound it.  Faster designs (register-blocked rows, tensor-core cost
// tiles) are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float BIG = 1e30f;
constexpr int TILE = 32;  // stream frames loaded into the ring at a time

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ring slots: a multiple of TILE, >= T + TILE, so that a tile never
// overwrites a frame a pending diagonal still reads
__host__ __device__ inline int ring_slots(int t_pad) { return round_up(t_pad + TILE, TILE); }

size_t smem_bytes(int t_pad, int fp) {
  int threads = round_up(t_pad, 32);
  int ring = ring_slots(t_pad);
  return sizeof(float) * ((size_t)ring * (fp + 1) + ring + 2 * threads) +
         sizeof(int) * 2 * threads;
}

template <int FP, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
spot_subseq_kernel(const float* __restrict__ streams, const int* __restrict__ stream_lens,
                   const float* __restrict__ bank, const int* __restrict__ bank_lens,
                   float* __restrict__ norm_out, int* __restrict__ start_out,
                   int n_templates, int u_pad, int t_pad, int f_dim, int squared) {
  constexpr int SF = FP + 1;  // odd row stride: frames fall on other banks
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int i = threadIdx.x;  // template row
  const int nt = blockDim.x;
  const int ring = ring_slots(t_pad);

  float* ring_f = smem;                      // [ring, SF] stream frames
  float* ring_sq = ring_f + ring * SF;       // [ring] |b|^2
  float* dbuf = ring_sq + ring;              // [2, nt] D of the last diagonals
  int* sbuf = reinterpret_cast<int*>(dbuf + 2 * nt);  // [2, nt] witnesses

  const int tl = min(max(bank_lens[k], 1), t_pad);
  const int sl = min(max(stream_lens[b], 1), u_pad);
  const float* sg = streams + (size_t)b * u_pad * f_dim;
  float* norm_row = norm_out + ((size_t)b * n_templates + k) * u_pad;
  int* start_row = start_out + ((size_t)b * n_templates + k) * u_pad;

  for (int j = sl + i; j < u_pad; j += nt) {
    norm_row[j] = BIG;
    start_row[j] = j;
  }

  float a[FP];
  float asq = 0.f;
#pragma unroll
  for (int f = 0; f < FP; ++f) {
    a[f] = (i < tl && f < f_dim) ? bank[((size_t)k * t_pad + i) * f_dim + f] : 0.f;
    asq = fmaf(a[f], a[f], asq);
  }

  float d_own = BIG, d_diag = BIG;  // D(i, j-1); D(i-1, j-1)
  int s_own = 0, s_diag = 0;
  int slot = (i == 0) ? 0 : ring - i;  // ring slot of frame j = d - i
  const int last = tl + sl - 2;
  for (int d = 0; d <= last; ++d) {
    if (d % TILE == 0 && d < sl) {  // block-uniform: frames [d, d + TILE)
      const int n_frames = min(TILE, sl - d);
      const int base = d % ring;     // ring is a multiple of TILE
      for (int idx = i; idx < n_frames * FP; idx += nt) {
        int jj = idx / FP, f = idx - jj * FP;
        ring_f[(base + jj) * SF + f] = f < f_dim ? sg[(size_t)(d + jj) * f_dim + f] : 0.f;
      }
      __syncthreads();
      if (i < n_frames) {
        const float* r = ring_f + (base + i) * SF;
        float s = 0.f;
#pragma unroll
        for (int f = 0; f < FP; ++f) s = fmaf(r[f], r[f], s);
        ring_sq[base + i] = s;
      }
      __syncthreads();
    }
    const int j = d - i;
    if (i < tl && j >= 0 && j < sl) {
      const float* r = ring_f + slot * SF;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int f = 0; f < FP; ++f) acc[f & 3] = fmaf(a[f], r[f], acc[f & 3]);
      const float dot = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      // no contraction: (|a|^2 + |b|^2) - 2ab, as the plain version rounds it
      float sq = fmaxf(__fsub_rn(__fadd_rn(asq, ring_sq[slot]), __fmul_rn(2.f, dot)), 0.f);
      const float c = squared ? sq : sqrtf(sq);
      float dv;
      int sv;
      if (i == 0) {
        dv = c;
        sv = j;
      } else {
        const int prev = ((d + 1) & 1) * nt;  // diagonal d - 1
        const float d_vert = dbuf[prev + i - 1];
        const int s_vert = sbuf[prev + i - 1];
        float m = d_vert;
        int sm = s_vert;
        if (j > 0 && !(d_vert < d_diag)) {  // diagonal wins ties
          m = d_diag;
          sm = s_diag;
        }
        dv = __fadd_rn(m, c);
        sv = sm;
        if (j > 0) {
          const float h = __fadd_rn(d_own, c);
          if (h < dv) {  // horizontal only when strictly smaller
            dv = h;
            sv = s_own;
          }
        }
        d_diag = d_vert;
        s_diag = s_vert;
      }
      const int cur = (d & 1) * nt;
      dbuf[cur + i] = dv;
      sbuf[cur + i] = sv;
      d_own = dv;
      s_own = sv;
      if (i == tl - 1) {
        norm_row[j] = dv / ((float)tl + (float)(j - sv + 1));
        start_row[j] = sv;
      }
    }
    slot = (slot + 1 == ring) ? 0 : slot + 1;
    __syncthreads();
  }
}

template <int FP>
int launch(const void* streams, const void* stream_lens, const void* bank,
           const void* bank_lens, void* norm, void* start, int n_streams,
           int n_templates, int u_pad, int t_pad, int f_dim, int squared,
           cudaStream_t stream) {
  const int threads = round_up(t_pad, 32);
  const size_t smem = smem_bytes(t_pad, FP);
  auto kernel = threads <= 256 ? spot_subseq_kernel<FP, 256> : spot_subseq_kernel<FP, 1024>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch's check does not see it
    return (int)err;
  }
  dim3 grid(n_templates, n_streams);
  kernel<<<grid, threads, smem, stream>>>(
      (const float*)streams, (const int*)stream_lens, (const float*)bank,
      (const int*)bank_lens, (float*)norm, (int*)start, n_templates, u_pad,
      t_pad, f_dim, squared);
  return (int)cudaGetLastError();
}

int padded_features(int f_dim) {
  if (f_dim <= 16) return 16;
  if (f_dim <= 40) return 40;
  if (f_dim <= 64) return 64;
  if (f_dim <= 128) return 128;
  return -1;
}

}  // namespace

extern "C" int spot_subseq(const void* streams, const void* stream_lens,
                           const void* bank, const void* bank_lens, void* norm,
                           void* start, int n_streams, int n_templates, int u_pad,
                           int t_pad, int f_dim, int squared, void* stream) {
  if (t_pad < 1 || t_pad > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (padded_features(f_dim)) {
    case 16: return launch<16>(streams, stream_lens, bank, bank_lens, norm, start,
                               n_streams, n_templates, u_pad, t_pad, f_dim, squared, s);
    case 40: return launch<40>(streams, stream_lens, bank, bank_lens, norm, start,
                               n_streams, n_templates, u_pad, t_pad, f_dim, squared, s);
    case 64: return launch<64>(streams, stream_lens, bank, bank_lens, norm, start,
                               n_streams, n_templates, u_pad, t_pad, f_dim, squared, s);
    case 128: return launch<128>(streams, stream_lens, bank, bank_lens, norm, start,
                                 n_streams, n_templates, u_pad, t_pad, f_dim, squared, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
