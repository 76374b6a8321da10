// Fused lip-ROI preprocessing for Hopper (sm_90a): channel mean, cv2
// INTER_LINEAR (half-pixel) bilinear resize and /255 in one pass.
//
// Replaces the TPU kernel multimodal_av_model_tpu/ops/pallas/lip_kernel.py
// (lip_preprocess_pallas, pallas_call at :69, body _kernel :30-45).  The plain
// PyTorch version of the same function is
// multimodal_av_model_tpu_torch/ops/resize.py:lip_frames_preprocess.
//
// What bounds it on the H100: bytes.  At the serving shape (512 frames of
// 128x128x3 uint8 -> 512x96x96 f32) it reads 25.2 MB and writes 18.9 MB,
// about 13 us at 3.35 TB/s, against about 0.1 GFLOP of lerp arithmetic.  A
// thread-per-pixel gather (12 scattered 1-byte loads per output pixel, each
// source byte fetched about 2.25 times) is bound by load instructions long
// before it reaches that rate.
//
// Design: one CTA per (frame, band of output rows); the band plan (output
// rows per band, first and last source row of each band, shared-memory
// bytes) is made on the host by ops/resize.py:lip_band_plan.  The band's
// source rows are contiguous in the HWC layout, so the CTA copies them into
// shared memory as one byte range with 16-byte cp.async loads; a ragged head
// and tail (frames and rows need not be 16-byte aligned) are copied byte by
// byte inside the same loop.  Each source byte is read from HBM once.  Then
// one pass makes the channel sum (C is a template parameter, so the channel
// loop unrolls) and the horizontal lerp of every staged row into an f32
// [rows, OW] buffer, and a second pass makes the vertical lerp and stores
// four neighbouring output pixels as one float4.  With the bytes staged, the
// kernel is bound by the instructions it issues per pixel, so the mean's 1/C
// and the /255 are one multiply in the store (no division), the loops step
// their indices without integer division, and the x table sits in shared
// memory as element offsets.  The lerp indices
// and weights come from the host (the ones the plain version uses, the
// half-pixel weights of resize_matrix), so kernel and plan cannot disagree
// on a source row.  tools/kernel_phases.py times the phases between the
// "PHASE:" markers below on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Sum of a pixel's C channels (CT of them, or c at run time) as a float.
// uint8 channels are summed as integers and converted once, by setting the
// sum into the mantissa of 2^23 (exact below 2^23): two full-rate ALU
// instructions where a conversion per byte would run at a quarter of the
// rate.  The result equals the float sum exactly.
template <int CT>
__device__ __forceinline__ float pixel_sum(const uint8_t* p, int c) {
  unsigned s = p[0];
#pragma unroll
  for (int i = 1; i < (CT > 0 ? CT : 1); ++i) s += p[i];
  if (CT == 0)
    for (int i = 1; i < c; ++i) s += p[i];
  return __uint_as_float(0x4B000000u | s) - 8388608.f;
}

template <int CT>
__device__ __forceinline__ float pixel_sum(const float* p, int c) {
  float s = p[0];
#pragma unroll
  for (int i = 1; i < (CT > 0 ? CT : 1); ++i) s += p[i];
  if (CT == 0)
    for (int i = 1; i < c; ++i) s += p[i];
  return s;
}

// idx = [ylo(OH) | yhi(OH) | xlo(OW) | xhi(OW) | band_first(NB) | band_last(NB)],
// frac = [yfrac(OH) | xfrac(OW)].  CT = 0 takes the channel count at run time
// (its channel loop needs more than the 32 registers that 8 CTAs an SM
// leave, so it asks for 4).
// Shared memory: [stage_bytes of source rows | x table: 3 x OW words | f32
// row buffer [rows, OW]].
template <typename T, int CT>
__global__ void __launch_bounds__(kThreads, CT == 0 ? 4 : 8)
lip_kernel(const T* __restrict__ frames,  // [N, H, W, C]
           float* __restrict__ out,       // [N, 1, OH, OW]
           const int* __restrict__ idx, const float* __restrict__ frac,
           int H, int W, int c_rt, int OH, int OW, int rows_per_band, int n_bands,
           int stage_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = CT > 0 ? CT : c_rt;
  const int band = blockIdx.x, n = blockIdx.y;
  const int* ylo = idx;
  const int* yhi = idx + OH;
  const int y_first = idx[2 * OH + 2 * OW + band];
  const int y_last = idx[2 * OH + 2 * OW + n_bands + band];
  const int nrows = y_last - y_first + 1;
  // PHASE: start

  // 1. Stage source rows y_first..y_last of frame n: bytes [gs, ge).  Shared
  // byte 0 holds the 16-byte aligned global address a0 <= gs.
  const size_t row_bytes = (size_t)W * C * sizeof(T);
  const uintptr_t gs = reinterpret_cast<uintptr_t>(frames) +
                       ((size_t)n * H + y_first) * row_bytes;
  const uintptr_t ge = gs + (size_t)nrows * row_bytes;
  const uintptr_t a0 = gs & ~(uintptr_t)15;
  const int n_chunks = (int)((ge - a0 + 15) >> 4);
  for (int i = threadIdx.x; i < n_chunks; i += kThreads) {
    const uintptr_t lo = a0 + ((uintptr_t)i << 4);
    unsigned char* dst = smem + ((size_t)i << 4);
    if (lo >= gs && lo + 16 <= ge) {
      cp_async_16(dst, reinterpret_cast<const void*>(lo));
    } else {                                   // ragged head or tail chunk
      for (int b = 0; b < 16; ++b) {
        const uintptr_t g = lo + b;
        if (g >= gs && g < ge) dst[b] = *reinterpret_cast<const unsigned char*>(g);
      }
    }
  }
  // The x table, as element offsets into a row: xlo*C, xhi*C, xfrac.
  int* xs_lo = reinterpret_cast<int*>(smem + stage_bytes);
  int* xs_hi = xs_lo + OW;
  float* xs_f = reinterpret_cast<float*>(xs_hi + OW);
  for (int x = threadIdx.x; x < OW; x += kThreads) {
    xs_lo[x] = __ldg(idx + 2 * OH + x) * C;
    xs_hi[x] = __ldg(idx + 2 * OH + OW + x) * C;
    xs_f[x] = __ldg(frac + OH + x);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // PHASE: rows staged

  // 2. Channel sum + horizontal lerp of every staged row: hbuf[r][ox].  The
  // mean's 1/C and the /255 are applied once, in the store.
  const T* src = reinterpret_cast<const T*>(smem + (gs - a0));
  float* hbuf = xs_f + OW;
  {
    const int step_r = kThreads / OW, step_x = kThreads % OW;
    int r = threadIdx.x / OW, ox = threadIdx.x - r * OW;
    for (; r < nrows; r += step_r) {
      const T* row = src + r * W * C;
      const float s0 = pixel_sum<CT>(row + xs_lo[ox], C);
      const float s1 = pixel_sum<CT>(row + xs_hi[ox], C);
      hbuf[r * OW + ox] = s0 + (s1 - s0) * xs_f[ox];
      ox += step_x;
      if (ox >= OW) { ox -= OW; ++r; }
    }
  }
  __syncthreads();
  // PHASE: grey + horizontal lerp

  // 3. Vertical lerp, scale, four output pixels per thread.
  const float scale = 1.f / (255.f * (float)C);
  const int oy0 = band * rows_per_band;
  const int oy1 = min(oy0 + rows_per_band, OH);
  const int quads = (OW + 3) >> 2;
  float* frame_out = out + (size_t)n * OH * OW;
  const int step_r = kThreads / quads, step_q = kThreads % quads;
  int r = threadIdx.x / quads, qd = threadIdx.x - r * quads;
  for (; r < oy1 - oy0; r += step_r) {
    const int ox = qd << 2, oy = oy0 + r;
    const float* top = hbuf + (__ldg(ylo + oy) - y_first) * OW;
    const float* bot = hbuf + (__ldg(yhi + oy) - y_first) * OW;
    const float fy = __ldg(frac + oy);
    float* dst = frame_out + (size_t)oy * OW + ox;
    if ((OW & 3) == 0) {                       // rows of hbuf and out are 16-byte aligned
      const float4 t = *reinterpret_cast<const float4*>(top + ox);
      const float4 b = *reinterpret_cast<const float4*>(bot + ox);
      *reinterpret_cast<float4*>(dst) = make_float4(
          (t.x + (b.x - t.x) * fy) * scale, (t.y + (b.y - t.y) * fy) * scale,
          (t.z + (b.z - t.z) * fy) * scale, (t.w + (b.w - t.w) * fy) * scale);
    } else {
      for (int j = 0; j < 4 && ox + j < OW; ++j)
        dst[j] = (top[ox + j] + (bot[ox + j] - top[ox + j]) * fy) * scale;
    }
    qd += step_q;
    if (qd >= quads) { qd -= quads; ++r; }
  }
  // PHASE: vertical lerp + store
}

template <typename T, int CT>
int launch(const void* frames, void* out, const int* idx, const float* frac,
           int N, int H, int W, int C, int OH, int OW, int rows_per_band,
           int n_bands, int stage_bytes, int smem_bytes, cudaStream_t stream) {
  auto kernel = lip_kernel<T, CT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_bands, N), kThreads, smem_bytes, stream>>>(
      (const T*)frames, (float*)out, idx, frac, H, W, C, OH, OW, rows_per_band,
      n_bands, stage_bytes);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_c(const void* frames, void* out, const int* idx, const float* frac,
             int N, int H, int W, int C, int OH, int OW, int rows_per_band,
             int n_bands, int stage_bytes, int smem_bytes, cudaStream_t stream) {
  if (C == 3)
    return launch<T, 3>(frames, out, idx, frac, N, H, W, C, OH, OW, rows_per_band,
                        n_bands, stage_bytes, smem_bytes, stream);
  if (C == 1)
    return launch<T, 1>(frames, out, idx, frac, N, H, W, C, OH, OW, rows_per_band,
                        n_bands, stage_bytes, smem_bytes, stream);
  return launch<T, 0>(frames, out, idx, frac, N, H, W, C, OH, OW, rows_per_band,
                      n_bands, stage_bytes, smem_bytes, stream);
}

}  // namespace

extern "C" {

// in_is_u8: 1 for uint8 frames, 0 for float32.  idx/frac: the device tables
// of ops/resize.py:lip_band_plan; stage_bytes: offset of the f32 row buffer in
// shared memory; smem_bytes: the launch's dynamic shared memory (opted in
// above 48 KB here).  Returns the cudaError_t of the launch (0 = success).
int mmav_lip_launch(const void* frames, void* out, const void* idx, const void* frac,
                    int N, int H, int W, int C, int OH, int OW, int rows_per_band,
                    int n_bands, int stage_bytes, int smem_bytes, int in_is_u8,
                    void* stream) {
  if (in_is_u8)
    return launch_c<uint8_t>(frames, out, (const int*)idx, (const float*)frac, N, H,
                             W, C, OH, OW, rows_per_band, n_bands, stage_bytes,
                             smem_bytes, (cudaStream_t)stream);
  return launch_c<float>(frames, out, (const int*)idx, (const float*)frac, N, H, W,
                         C, OH, OW, rows_per_band, n_bands, stage_bytes, smem_bytes,
                         (cudaStream_t)stream);
}

const char* mmav_lip_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
