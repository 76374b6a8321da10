// Fused log-mel frontend for Hopper (sm_90a): reflect-pad framing, windowed
// DFT, power, mel projection and log in one pass over the waveform.
//
// Replaces the TPU kernel multimodal_av_model_tpu/ops/pallas/logmel_kernel.py
// (log_mel_spectrogram_pallas, pallas_call at :164, body _kernel :65-107).
// The plain PyTorch version of the same function is
// multimodal_av_model_tpu_torch/ops/logmel.py:log_mel_spectrogram.
//
// What bounds it on the H100: operations.  At the serving shape [4, 68352]
// the direct DFT does 2*400*201*2 flops per frame for re/im and 2*201*80 for
// the mel projection, over 1,712 frames: about 0.61 GFLOP of f32 work, about
// 9 us at the 67 TFLOP/s f32 peak, against about 1.6 MB of waveform in and
// features out (0.5 us at 3.35 TB/s).  The JAX kernel pins HIGHEST precision,
// so the products stay in f32 FMA on the CUDA cores: no TF32 tensor cores.
//
// Design: one CTA per (batch row, tile of TILE frames).  The CTA copies the
// tile's span of the waveform into shared memory once, computing the reflect
// padding indices itself, so the [T, n_fft] frame matrix never exists.  Thread
// f owns frequency bin f and keeps re/im for all TILE frames in registers; per
// sample n it reads one windowed cos/sin basis value (coalesced across the
// warp, L2-resident) and broadcasts the tile's samples from shared memory, so
// each basis load feeds 2*TILE FMAs.  The power goes to shared memory, the mel
// GEMM reads it from there, and the log is applied in the store.  The TPU
// kernel's [B, hop, R] hop-column layout and pltpu.roll existed only for
// Mosaic's lane alignment and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;  // frames per CTA

__global__ void logmel_kernel(const float* __restrict__ sig,   // [B, S]
                              const float* __restrict__ wcos,  // [n_fft, F]
                              const float* __restrict__ wsin,  // [n_fft, F]
                              const float* __restrict__ fb,    // [F, n_mels]
                              float* __restrict__ out,         // [B, T, n_mels]
                              int S, int T, int n_fft, int hop, int F,
                              int n_mels, int pad, float log_eps,
                              int apply_log) {
  extern __shared__ float smem[];
  const int span = (TILE - 1) * hop + n_fft;
  float* wave = smem;            // [span]
  float* power = smem + span;    // [TILE, F]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int nt = min(TILE, T - t0);
  const int valid_span = (nt - 1) * hop + n_fft;
  const float* row = sig + (size_t)b * S;

  // Waveform span of this tile, reflect-padded by `pad` samples at each end
  // (numpy/torch "reflect": the edge sample is not repeated).
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    float v = 0.f;
    if (i < valid_span) {
      int src = t0 * hop + i - pad;
      if (src < 0) src = -src;
      if (src >= S) src = 2 * (S - 1) - src;
      v = row[src];
    }
    wave[i] = v;
  }
  __syncthreads();

  const int f = threadIdx.x;
  if (f < F) {
    float re[TILE], im[TILE];
#pragma unroll
    for (int t = 0; t < TILE; ++t) { re[t] = 0.f; im[t] = 0.f; }
#pragma unroll 4
    for (int n = 0; n < n_fft; ++n) {
      const float c = wcos[n * F + f];
      const float s = wsin[n * F + f];
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const float x = wave[t * hop + n];
        re[t] = fmaf(x, c, re[t]);
        im[t] = fmaf(x, s, im[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < TILE; ++t) power[t * F + f] = re[t] * re[t] + im[t] * im[t];
  }
  __syncthreads();

  for (int o = threadIdx.x; o < nt * n_mels; o += blockDim.x) {
    const int t = o / n_mels;
    const int m = o - t * n_mels;
    const float* p = power + t * F;
    float acc = 0.f;
    for (int k = 0; k < F; ++k) acc = fmaf(p[k], fb[k * n_mels + m], acc);
    out[((size_t)b * T + t0 + t) * n_mels + m] = apply_log ? logf(acc + log_eps) : acc;
  }
}

}  // namespace

extern "C" {

// Shared memory the launch needs, in bytes (the wrapper checks it).
int mmav_logmel_smem_bytes(int n_fft, int hop, int F) {
  return (int)(((TILE - 1) * hop + n_fft + TILE * F) * sizeof(float));
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int mmav_logmel_launch(const void* sig, const void* wcos, const void* wsin,
                       const void* fb, void* out, int B, int S, int T,
                       int n_fft, int hop, int F, int n_mels, int pad,
                       float log_eps, int apply_log, void* stream) {
  const int threads = ((F + 31) / 32) * 32;
  const dim3 grid((T + TILE - 1) / TILE, B);
  const size_t smem = (size_t)mmav_logmel_smem_bytes(n_fft, hop, F);
  logmel_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)sig, (const float*)wcos, (const float*)wsin,
      (const float*)fb, (float*)out, S, T, n_fft, hop, F, n_mels, pad,
      log_eps, apply_log);
  return (int)cudaGetLastError();
}

const char* mmav_logmel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
