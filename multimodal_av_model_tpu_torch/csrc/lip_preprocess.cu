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
// about 13 us at 3.35 TB/s, against about 0.1 GFLOP of lerp arithmetic.
//
// Design: one thread per output pixel, frames on grid.y.  The TPU kernel ran
// the resize as two dense matmuls (R_y * g * R_x^T) only because gathers lower
// badly on the TPU; here each thread gathers its 2x2 source pixels directly
// and lerps with the same half-pixel weights as ops/resize.py:resize_matrix.
// The input is read as stored (uint8 by default), not cast to f32 first as the
// JAX path does, so the read is a quarter of the f32 bytes.  Neighbouring
// threads read neighbouring source columns, so a warp's loads fall in a few
// 128-byte lines.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void src_coord(int o, int in_size, float scale,
                                          int* lo, int* hi, float* frac) {
  float s = (o + 0.5f) * scale - 0.5f;
  s = fminf(fmaxf(s, 0.f), (float)(in_size - 1));
  const int l = (int)floorf(s);
  *lo = l;
  *hi = min(l + 1, in_size - 1);
  *frac = s - (float)l;
}

template <typename T>
__global__ void lip_kernel(const T* __restrict__ frames,  // [N, H, W, C]
                           float* __restrict__ out,       // [N, 1, OH, OW]
                           int H, int W, int C, int OH, int OW,
                           float scale_y, float scale_x) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= OH * OW) return;
  const int n = blockIdx.y;
  const int oy = o / OW;
  const int ox = o - oy * OW;
  int y0, y1, x0, x1;
  float fy, fx;
  src_coord(oy, H, scale_y, &y0, &y1, &fy);
  src_coord(ox, W, scale_x, &x0, &x1, &fx);

  const T* img = frames + (size_t)n * H * W * C;
  const float inv_c = 1.f / (float)C;
  auto gray = [&](int y, int x) {
    const T* p = img + ((size_t)y * W + x) * C;
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += (float)p[c];
    return s * inv_c;
  };
  const float g00 = gray(y0, x0), g01 = gray(y0, x1);
  const float g10 = gray(y1, x0), g11 = gray(y1, x1);
  const float left = g00 + (g10 - g00) * fy;
  const float right = g01 + (g11 - g01) * fy;
  out[(size_t)n * OH * OW + o] = (left + (right - left) * fx) / 255.f;
}

}  // namespace

extern "C" {

// in_is_u8: 1 for uint8 frames, 0 for float32.  Returns the cudaError_t of
// the launch (0 = success).
int mmav_lip_launch(const void* frames, void* out, int N, int H, int W, int C,
                    int OH, int OW, int in_is_u8, void* stream) {
  const int threads = 256;
  const dim3 grid((OH * OW + threads - 1) / threads, N);
  const float sy = (float)H / (float)OH, sx = (float)W / (float)OW;
  if (in_is_u8) {
    lip_kernel<uint8_t><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)frames, (float*)out, H, W, C, OH, OW, sy, sx);
  } else {
    lip_kernel<float><<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)frames, (float*)out, H, W, C, OH, OW, sy, sx);
  }
  return (int)cudaGetLastError();
}

const char* mmav_lip_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
