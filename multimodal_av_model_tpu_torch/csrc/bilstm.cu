// The recurrence of an LSTM layer, both directions, for Hopper (sm_90a): K4.
// One launch runs every frame of a layer forward, and one more runs its
// backward; the frame loop is inside the kernels.
//
// Replaces no TPU kernel.  The JAX package runs the BiLSTM as lax.scan
// (multimodal_av_model_tpu/models/layers.py:86-266), one loop on the device
// under XLA.  The port's plain version (multimodal_av_model_tpu_torch/models/
// layers.py: _lstm_scan) issues about 16 kernels a frame from a Python loop
// and autograd about twice as many backward, some 4,100 launches a request and
// 12,000 a training step at the flagship's 2 layers x 128 frames, and the card
// waits on the host through nearly all of it.
//
// What bounds it on the H100: a serial chain of frames.  Frame t + 1 needs
// h_t, so a layer takes its frames' count times the latency of one step.  The
// work of a step is small (the flagship's [R, 512] x [512, 2048] product is 17
// MFLOP at R = 8), and W_hh, 2 MiB a direction in bf16, would take 0.6 us to
// read from device memory every frame.  The design keeps the step short and
// W_hh on chip:
//
// * Grid: a thread-block cluster of `cs` CTAs per direction and per group of
//   8 or 16 rows (the rows are independent; more rows take more clusters,
//   which run side by side: a train_b8 step's 16 rows are 2 groups of 8 a
//   direction, 64 CTAs).  A CTA owns U hidden units (U a multiple of 16,
//   cs * U >= H) and their 4U gate columns of W_hh, which it loads once into
//   shared memory and keeps for the whole sequence (at the flagship's H = 512
//   in bf16: 16 CTAs of 128 KiB).  The cluster size follows H: in bf16 the
//   smallest that holds W_hh, one CTA at small H (ops/lstm_scan.py:
//   lstm_scan_plan).  Where a slice does not fit, and always in f32 (whose
//   speed no cell measures), the CTA writes it once into device scratch in
//   the same layout and reads it from L2 every frame.
// * A step, forward: each warp takes 16 gate columns (4 units x 4 gates) and
//   forms them for every row from the full h_{t-1}, which each CTA holds in
//   shared memory: bf16 with tensor-core mma.sync m16n8k16 (operands by
//   ldmatrix, two chains of f32 sums), f32 with FMAs in f32 (no lower
//   precision than the plain loop's).  The gate columns are ordered so that a
//   lane and its partner 16 lanes away hold the four gates of one unit for
//   two rows; after one shuffle each lane finishes one (row, unit): the carry
//   c and the gate math stay in f32, h is rounded to the compute dtype as the
//   plain loop rounds it.
// * The CTA writes its slice of h_t into its own buffer and pushes it, 16
//   bytes a store, into every other CTA's through distributed shared memory;
//   one cluster barrier a frame orders it, split into arrive and wait.  h is
//   double-buffered, so the next frame's pushes cannot race this frame's
//   reads.  Device memory stays off the chain: between arrive and wait the
//   CTA copies the next step's inputs (x W_ih) into shared memory with
//   cp.async and writes this step's outputs (y, the saved values), staged in
//   shared memory, out in 16-byte stores.
// * Lengths: a row advances on its first `len` steps only, the forward
//   direction from frame 0, the backward direction from its last valid frame
//   with a zero carry; frames past the length output exactly 0.  The cluster
//   stops after its longest row.  These are _lstm_scan's semantics exactly.
// * Training: the forward saves i, f, g, o and c per valid frame, f32
//   [D, T, R, 5, H]; the backward kernel walks the steps in reverse with the
//   same cluster layout.  Each CTA forms its units' dgates (= dz) from dy,
//   the carried dc and the summed dh, then its partial dh_{t-1} = dgates W_hh
//   over all H (W_hh^T slice in shared memory, the same product), and sends
//   each destination CTA its units' part through distributed shared memory;
//   the owner sums the cs partials after the barrier.  dy and the saved
//   values come in, and dz goes out, as the forward's inputs and outputs do.
//   dW_hh and db are one product and one sum over all frames after the kernel
//   (ops/lstm_scan.py).
// * Where a frame goes (clock64 on one CTA, [128, 2, 8, 2048] bf16, H100;
//   tools/kernel_phases.py stamps the clock at the PHASE markers below):
//   forward ~7,300 clocks, of which the product 1,850, the gate math 1,100,
//   the push 800, the barrier's release 1,300 and the device-memory traffic
//   2,000 (its issue, in the barrier's shadow, outlasts the barrier);
//   backward ~15,000, of which the staging of dy and the saved values 5,400.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 2;   // row tiles of 8: at most 16 rows a cluster

struct Shape {
  int R, T, D, H;   // rows, frames, directions, hidden units
  int cs, U, KP;    // cluster size, units a CTA (a multiple of 16), cs * U
  int rows;         // rows a cluster (8 or 16)
  int w_in_smem;    // the CTA's W_hh slice sits in shared memory, else in scratch
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);          // round to nearest even, as .to(torch.bfloat16)
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ int row_length(const void* lengths, int len64, int row, int T) {
  const long long n = len64 ? ((const long long*)lengths)[row] : ((const int*)lengths)[row];
  return (int)min(max(n, 0LL), (long long)T);
}

// The frame step s of a row of `len` valid frames reads: the forward
// direction from frame 0, the backward one from the row's last valid frame.
__device__ __forceinline__ int frame(int d, int s, int len) { return d == 0 ? s : len - 1 - s; }

// A CTA's gate columns come in tiles of 16: 4 units x 4 gates (i, f, g, o),
// local column 16 (ul / 4) + 4 q + ul % 4 for gate q of local unit ul.
__device__ __forceinline__ int local_col(int q, int ul) {
  return 16 * (ul >> 2) + 4 * q + (ul & 3);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The cluster barrier in two halves: the release orders this thread's
// earlier writes (the pushes into other CTAs' shared memory) before the
// barrier; what runs between arrive and wait overlaps the barrier's latency.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Copy `segs` segments of `len` elements of E between device and shared
// memory, all of the CTA's threads together: 16 bytes at a time where `vec`
// (every segment whole and 16-byte aligned at both ends), else the first
// `valid` elements of each one by one.  glob(seg) gives a segment's device
// address, or null to skip it; sh(seg) its shared one.  In: cp.async, landed
// by the next cp_async_wait_all.  Out: plain stores.
template <typename E, typename Glob, typename Sh>
__device__ __forceinline__ void stage_in(int segs, int len, int valid, bool vec, Glob glob, Sh sh) {
  if (vec) {
    const int per = len * (int)sizeof(E) / 16;
    for (int i = threadIdx.x; i < segs * per; i += kThreads) {
      const int seg = i / per, c = i - seg * per;
      const E* from = glob(seg);
      if (from) cp_async16(reinterpret_cast<unsigned char*>(sh(seg)) + 16 * c,
                           reinterpret_cast<const unsigned char*>(from) + 16 * c);
    }
  } else {
    for (int i = threadIdx.x; i < segs * valid; i += kThreads) {
      const int seg = i / valid, e = i - seg * valid;
      const E* from = glob(seg);
      if (from) sh(seg)[e] = from[e];
    }
  }
  cp_async_commit();
}

template <typename E, typename Glob, typename Sh>
__device__ __forceinline__ void stage_out(int segs, int len, int valid, bool vec, Glob glob,
                                          Sh sh) {
  if (vec) {
    const int per = len * (int)sizeof(E) / 16;
    for (int i = threadIdx.x; i < segs * per; i += kThreads) {
      const int seg = i / per, c = i - seg * per;
      E* to = glob(seg);
      if (to) *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(to) + 16 * c) =
          *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(sh(seg)) + 16 * c);
    }
  } else {
    for (int i = threadIdx.x; i < segs * valid; i += kThreads) {
      const int seg = i / valid, e = i - seg * valid;
      E* to = glob(seg);
      if (to) to[e] = sh(seg)[e];
    }
  }
}

// acc[nt] += A . B_nt^T over `extent` (a multiple of 16) of the reduced
// dimension, contiguous in both operands: A's 16 rows from a (row stride
// astride), B's row n at b + n * bstride, row tile nt holding rows 8 nt ..
// 8 nt + 7.  acc[nt] is mma's C fragment: [0] (g, 2t), [1] (g, 2t + 1),
// [2] (g + 8, 2t), [3] (g + 8, 2t + 1), g = lane / 4, t = lane % 4.
// bf16: tensor-core mma.sync m16n8k16 with f32 sums, two chains over
// alternate k-tiles, the operands by ldmatrix where both sit in shared memory
// (kSmem); f32: FMAs in f32 into the same fragment.  kTiles: the row tiles
// where fixed at compile time, else 0 and `tiles`.
template <typename T, bool kSmem, int kTiles>
__device__ __forceinline__ void tile_product(float (&acc)[kMaxTiles][4], const T* a, int astride,
                                             const T* b, int bstride, int extent, int tiles,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int nts = kTiles ? kTiles : tiles;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && kSmem && kTiles > 0) {
    // ldmatrix: lane l gives the address of row l % 8 of matrix l / 8.  A
    // (x4): rows 0-7 and 8-15 at k and k + 8, mma's a0..a3; B (x4): rows
    // 0-7 at k, k + 8, k + 16, k + 24, two k-tiles' b0, b1.
    const int r = lane & 7, mi = lane >> 3;
    const T* ap = a + (size_t)(r + 8 * (mi & 1)) * astride + 8 * (mi >> 1);
    const T* bp = b + (size_t)r * bstride + 8 * mi;
    float acc2[kMaxTiles][4] = {};
    int j = 0;
#pragma unroll 2
    for (; j + 32 <= extent; j += 32) {
      uint32_t x[4], y[4];
      ldsm_x4(x, ap + j);
      ldsm_x4(y, ap + j + 16);
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        uint32_t v[4];
        ldsm_x4(v, bp + (size_t)nt * 8 * bstride + j);
        mma_bf16(acc[nt], x[0], x[1], x[2], x[3], v[0], v[1]);
        mma_bf16(acc2[nt], y[0], y[1], y[2], y[3], v[2], v[3]);
      }
    }
    if (j < extent) {
      uint32_t x[4];
      ldsm_x4(x, ap + j);
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        uint32_t v[2];
        ldsm_x2(v, bp + (size_t)nt * 8 * bstride + j);
        mma_bf16(acc[nt], x[0], x[1], x[2], x[3], v[0], v[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kMaxTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += acc2[nt][e];
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const T* a0 = a + (size_t)g * astride;
    const T* a1 = a0 + (size_t)8 * astride;
    for (int j = 0; j < extent; j += 16) {
      const int k = j + 2 * t;
      const uint32_t x0 = ld32(a0 + k), x1 = ld32(a1 + k), x2 = ld32(a0 + k + 8),
                     x3 = ld32(a1 + k + 8);
#pragma unroll
      for (int nt = 0; nt < kMaxTiles; ++nt) {
        if (nt < nts) {
          const T* br = b + (size_t)(nt * 8 + g) * bstride + k;
          mma_bf16(acc[nt], x0, x1, x2, x3, ld32(br), ld32(br + 8));
        }
      }
    }
  } else {
    const T* a0 = a + (size_t)g * astride;
    const T* a1 = a0 + (size_t)8 * astride;
    for (int j = 0; j < extent; j += 4) {
      const float4 w0 = *reinterpret_cast<const float4*>(a0 + j);
      const float4 w1 = *reinterpret_cast<const float4*>(a1 + j);
#pragma unroll
      for (int nt = 0; nt < kMaxTiles; ++nt) {
        if (nt < nts) {
          const float* br = b + (size_t)(nt * 8 + 2 * t) * bstride + j;
          const float4 h0 = *reinterpret_cast<const float4*>(br);
          const float4 h1 = *reinterpret_cast<const float4*>(br + bstride);
          float* c = acc[nt];
          c[0] = fmaf(w0.w, h0.w, fmaf(w0.z, h0.z, fmaf(w0.y, h0.y, fmaf(w0.x, h0.x, c[0]))));
          c[1] = fmaf(w0.w, h1.w, fmaf(w0.z, h1.z, fmaf(w0.y, h1.y, fmaf(w0.x, h1.x, c[1]))));
          c[2] = fmaf(w1.w, h0.w, fmaf(w1.z, h0.z, fmaf(w1.y, h0.y, fmaf(w1.x, h0.x, c[2]))));
          c[3] = fmaf(w1.w, h1.w, fmaf(w1.z, h1.z, fmaf(w1.y, h1.y, fmaf(w1.x, h1.x, c[3]))));
        }
      }
    }
  }
}

// Shared memory of a CTA (ops/lstm_scan.py: _smem_bytes mirrors these).
template <typename T>
size_t forward_smem(const Shape& p) {
  const size_t ks = p.KP + 8, u = p.U, r = p.rows;
  return ((p.w_in_smem ? 4 * u * ks : 0) + 2 * r * ks + 4 * r * u + r * u) * sizeof(T) +
         (4 * u + r * u + 5 * r * u) * sizeof(float) + r * sizeof(int);
}

template <typename T>
size_t backward_smem(const Shape& p) {
  const size_t ms = 4 * (size_t)p.U + 8, u = p.U, r = p.rows;
  return ((p.w_in_smem ? (size_t)p.KP * ms : 0) + r * ms + r * u + 4 * r * u) * sizeof(T) +
         (2 * (size_t)p.cs * u * r + 6 * r * u + r * u) * sizeof(float) + r * sizeof(int);
}

// z [R, T, D, 4H], lengths [R], w [D, 4H, H] (the parameter's layout), bias
// [D, 4H], y [R, T, D, H]; saved [D, T, R, 5, H] f32 or null; wscratch: the
// W_hh slices where they do not fit in shared memory (kWSmem false).
// kTiles: the row tiles a cluster, or 0 to read them from p.rows.
template <typename T, bool kWSmem, int kTiles>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_forward(const T* __restrict__ z, const void* __restrict__ lengths, int len64,
                 const T* __restrict__ w, const T* __restrict__ bias, T* __restrict__ y,
                 float* __restrict__ saved, T* wscratch, Shape p) {
  // PHASE: forward start.
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y, row0 = blockIdx.z * p.rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = p.H, T_ = p.T, U = p.U, KP = p.KP, KS = p.KP + 8, rows = p.rows, cs = p.cs;
  const int u0 = rank * U;
  const size_t G4 = 4 * (size_t)H;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* at = smem;
  T* ws;                                        // [4U][KS]: this CTA's W_hh rows
  if constexpr (kWSmem) {
    ws = reinterpret_cast<T*>(at);
    at += 4 * (size_t)U * KS * sizeof(T);
  } else {
    ws = wscratch + ((size_t)(blockIdx.z * p.D + d) * cs + rank) * 4 * U * KS;
  }
  T* hbuf = reinterpret_cast<T*>(at);           // [2][rows][KS]: h_{t-1}, h_t
  at += 2 * (size_t)rows * KS * sizeof(T);
  T* zst = reinterpret_cast<T*>(at);            // [rows][4][U]: the step's x W_ih
  at += (size_t)rows * 4 * U * sizeof(T);
  T* yst = reinterpret_cast<T*>(at);            // [rows][U]: the step's h, to y
  at += (size_t)rows * U * sizeof(T);
  float* bst = reinterpret_cast<float*>(at);    // [4][U]: the bias
  at += 4 * (size_t)U * sizeof(float);
  float* cst = reinterpret_cast<float*>(at);    // [rows][U]: the carry
  at += (size_t)rows * U * sizeof(float);
  float* sst = reinterpret_cast<float*>(at);    // [rows][5][U]: the step's i, f, g, o, c
  at += (size_t)rows * 5 * U * sizeof(float);
  int* lens = reinterpret_cast<int*>(at);

  for (int n = tid; n < rows; n += kThreads)
    lens[n] = row0 + n < p.R ? row_length(lengths, len64, row0 + n, T_) : 0;
  for (int i = tid; i < 2 * rows * KS; i += kThreads) hbuf[i] = from_f<T>(0.f);
  for (int i = tid; i < rows * U; i += kThreads) cst[i] = 0.f;
  for (int i = tid; i < 4 * U; i += kThreads) {
    const int q = i / U, u = u0 + i % U;
    bst[i] = u < H ? to_f(bias[(size_t)d * G4 + (size_t)q * H + u]) : 0.f;
  }
  const T* wd = w + (size_t)d * G4 * H;
  for (int i = tid; i < 4 * U * KP; i += kThreads) {
    const int m = i / KP, k = i - m * KP;
    const int q = (m & 15) >> 2, u = u0 + 4 * (m >> 4) + (m & 3);
    ws[(size_t)m * KS + k] = (u < H && k < H) ? wd[((size_t)q * H + u) * H + k] : from_f<T>(0.f);
  }
  __syncthreads();
  int steps = 0;
  for (int n = 0; n < rows; ++n) steps = max(steps, lens[n]);
  // Frames past a row's length output 0 (this CTA's units).
  for (int n = 0; n < rows && row0 + n < p.R; ++n) {
    const int len = lens[n];
    T* yr = y + (size_t)(row0 + n) * T_ * p.D * H + (size_t)d * H + u0;
    for (int i = tid; i < (T_ - len) * U; i += kThreads) {
      const int tf = len + i / U, ul = i % U;
      if (u0 + ul < H) yr[(size_t)tf * p.D * H + ul] = from_f<T>(0.f);
    }
  }
  // A step's inputs come in, and its outputs go out, through shared memory,
  // in the barrier's shadow: segments (row n, gate q) of z, (row n) of y and
  // (row n, value v) of saved, each this CTA's U units.
  const int valid = max(0, min(U, H - u0));
  // 16-byte copies where the CTA's slice is whole (u0 + U <= H) and every
  // segment starts 16-byte aligned.  Written as a bound on u0: a `valid == U`
  // here compiled to true for partial slices, and the 16-byte copies of dz
  // then ran past a gate's H columns into the next one's.
  const bool vec = (H * (int)sizeof(T)) % 16 == 0 && H - u0 >= U;
  auto row_of = [&](int n, int s) -> size_t {   // (row, frame, direction) at step s
    return ((size_t)(row0 + n) * T_ + frame(d, s, lens[n])) * p.D + d;
  };
  auto stage_z = [&](int s) {
    stage_in<T>(rows * 4, U, valid, vec,
                [&](int seg) -> const T* {
                  const int n = seg >> 2;
                  return s < lens[n] ? z + row_of(n, s) * G4 + (size_t)(seg & 3) * H + u0 : nullptr;
                },
                [&](int seg) { return zst + (size_t)seg * U; });
  };
  auto write_out = [&](int s) {
    stage_out<T>(rows, U, valid, vec,
                 [&](int n) -> T* { return s < lens[n] ? y + row_of(n, s) * H + u0 : nullptr; },
                 [&](int n) { return yst + (size_t)n * U; });
    if (saved)
      stage_out<float>(rows * 5, U, valid, vec,
                       [&](int seg) -> float* {
                         const int n = seg / 5;
                         if (s >= lens[n]) return nullptr;
                         const size_t fr = ((size_t)d * T_ + frame(d, s, lens[n])) * p.R + row0 + n;
                         return saved + (fr * 5 + seg % 5) * H + u0;
                       },
                       [&](int seg) { return sst + (size_t)seg * U; });
  };
  if (steps > 0) stage_z(0);
  cluster.sync();   // every CTA of the cluster runs and holds zeros before any push
  // PHASE: forward set-up: W_hh's slice in shared memory, zeros past the lengths.

  const int tiles = kTiles ? kTiles : rows / 8, g = lane >> 2, t = lane & 3;
  const bool lo = g < 4;          // lo lanes finish row 2t, their partners row 2t + 1
  const int cpr = U * (int)sizeof(T) / 16;
  for (int s = 0; s < steps; ++s) {
    // PHASE: forward frames before the last.
    cp_async_wait_all();
    __syncthreads();                            // the step's inputs are in
    const T* hcur = hbuf + (size_t)(s & 1) * rows * KS;
    T* hnext = hbuf + (size_t)((s + 1) & 1) * rows * KS;
    for (int mt = warp; mt < U / 4; mt += kWarps) {
      const int ul = 4 * mt + (g & 3), u = u0 + ul;
      float acc[kMaxTiles][4] = {};
      tile_product<T, kWSmem, kTiles>(acc, ws + (size_t)16 * mt * KS, KS, hcur, KS, KP, tiles,
                                      lane);
      // PHASE: forward product (of the last frame, as every phase below).
#pragma unroll
      for (int nt = 0; nt < kMaxTiles; ++nt) {
        if (nt >= tiles) break;                    // uniform across the warp
        const float* v = acc[nt];
        // lo lanes hold i and g, their partners f and o, each for rows 2t and 2t + 1.
        const float ra = __shfl_xor_sync(0xffffffffu, lo ? v[1] : v[0], 16);
        const float rb = __shfl_xor_sync(0xffffffffu, lo ? v[3] : v[2], 16);
        const float ai = lo ? v[0] : ra, af = lo ? ra : v[1];
        const float ag = lo ? v[2] : rb, ao = lo ? rb : v[3];
        const int n = nt * 8 + 2 * t + (lo ? 0 : 1);
        if (!(u < H && s < lens[n])) continue;
        const T* zn = zst + (size_t)n * 4 * U + ul;
        const float ig = sigmoid(ai + to_f(zn[0]) + bst[ul]);
        const float fg = sigmoid(af + to_f(zn[U]) + bst[U + ul]);
        const float gg = tanhf(ag + to_f(zn[2 * U]) + bst[2 * U + ul]);
        const float og = sigmoid(ao + to_f(zn[3 * U]) + bst[3 * U + ul]);
        float* cp = cst + n * U + ul;
        const float c = fg * *cp + ig * gg;
        *cp = c;
        const T h = from_f<T>(og * tanhf(c));
        hnext[(size_t)n * KS + u] = h;
        yst[n * U + ul] = h;
        float* sv = sst + (size_t)n * 5 * U + ul;
        sv[0] = ig;
        sv[U] = fg;
        sv[2 * U] = gg;
        sv[3 * U] = og;
        sv[4 * U] = c;
      }
    }
    // PHASE: forward gate math.
    __syncthreads();
    // This CTA's slice of h_t into every other CTA's buffer, 16 bytes a
    // store, one (chunk, destination) pair a thread at a time.
    for (int i = tid; i < rows * cpr * (cs - 1); i += kThreads) {
      const int pair = i / (cs - 1), r = i - pair * (cs - 1) + (i - pair * (cs - 1) >= rank);
      const int n = pair / cpr, c = pair - n * cpr;
      const size_t off = ((size_t)n * KS + u0) * sizeof(T) + (size_t)c * 16;
      unsigned char* to = reinterpret_cast<unsigned char*>(cluster.map_shared_rank(hnext, r));
      *reinterpret_cast<uint4*>(to + off) =
          *reinterpret_cast<const uint4*>(reinterpret_cast<unsigned char*>(hnext) + off);
    }
    // PHASE: forward push of h_t.
    cluster_arrive();
    if (s + 1 < steps) stage_z(s + 1);
    write_out(s);
    // PHASE: forward inputs in, outputs out.
    cluster_wait();
  }
  // PHASE: forward barrier.
}

// dy [R, T, D, H], saved [D, T, R, 5, H] f32 from the forward, w [D, 4H, H];
// dz [R, T, D, 4H] (the gates' gradient, 0 past each length); wscratch: the
// transposed W_hh slices where they do not fit in shared memory.
template <typename T, bool kWSmem, int kTiles>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_backward(const T* __restrict__ dy, const void* __restrict__ lengths, int len64,
                  const T* __restrict__ w, const float* __restrict__ saved, T* __restrict__ dz,
                  T* wscratch, Shape p) {
  // PHASE: backward start.
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int d = blockIdx.y, row0 = blockIdx.z * p.rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = p.H, T_ = p.T, U = p.U, KP = p.KP, MS = 4 * p.U + 8, rows = p.rows, cs = p.cs;
  const int u0 = rank * U;
  const size_t G4 = 4 * (size_t)H;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* at = smem;
  T* wt;                                        // [KP][MS]: W_hh^T over this CTA's gate columns
  if constexpr (kWSmem) {
    wt = reinterpret_cast<T*>(at);
    at += (size_t)KP * MS * sizeof(T);
  } else {
    wt = wscratch + ((size_t)(blockIdx.z * p.D + d) * cs + rank) * KP * MS;
  }
  T* da = reinterpret_cast<T*>(at);             // [rows][MS]: this step's dgates
  at += (size_t)rows * MS * sizeof(T);
  T* dyst = reinterpret_cast<T*>(at);           // [rows][U]: the step's dy
  at += (size_t)rows * U * sizeof(T);
  T* dzst = reinterpret_cast<T*>(at);           // [rows][4][U]: the step's dgates, to dz
  at += (size_t)rows * 4 * U * sizeof(T);
  float* recv = reinterpret_cast<float*>(at);   // [2][cs][U][rows]: partial dh from each CTA
  at += 2 * (size_t)cs * U * rows * sizeof(float);
  float* svst = reinterpret_cast<float*>(at);   // [rows][6][U]: i, f, g, o, c, c_{t-1}
  at += (size_t)rows * 6 * U * sizeof(float);
  float* dcs = reinterpret_cast<float*>(at);    // [rows][U]: the carried dc
  at += (size_t)rows * U * sizeof(float);
  int* lens = reinterpret_cast<int*>(at);

  for (int n = tid; n < rows; n += kThreads)
    lens[n] = row0 + n < p.R ? row_length(lengths, len64, row0 + n, T_) : 0;
  for (int i = tid; i < rows * U; i += kThreads) dcs[i] = 0.f;
  const T* wd = w + (size_t)d * G4 * H;
  for (int i = tid; i < 4 * U * KP; i += kThreads) {
    const int m = i / KP, k = i - m * KP;
    const int q = (m & 15) >> 2, u = u0 + 4 * (m >> 4) + (m & 3);
    wt[(size_t)k * MS + m] = (u < H && k < H) ? wd[((size_t)q * H + u) * H + k] : from_f<T>(0.f);
  }
  __syncthreads();
  int steps = 0;
  for (int n = 0; n < rows; ++n) steps = max(steps, lens[n]);
  for (int n = 0; n < rows && row0 + n < p.R; ++n) {
    const int len = lens[n];
    T* zr = dz + (size_t)(row0 + n) * T_ * p.D * G4 + (size_t)d * G4 + u0;
    for (int i = tid; i < (T_ - len) * 4 * U; i += kThreads) {
      const int tf = len + i / (4 * U), j = i % (4 * U), q = j / U, ul = j % U;
      if (u0 + ul < H) zr[(size_t)tf * p.D * G4 + (size_t)q * H + ul] = from_f<T>(0.f);
    }
  }
  // A step's dy, saved values and the previous frame's c come in, and its
  // dgates go out, through shared memory in the barrier's shadow.
  const int valid = max(0, min(U, H - u0));
  const bool vec = (H * (int)sizeof(T)) % 16 == 0 && H - u0 >= U;
  auto row_of = [&](int n, int s) -> size_t {
    return ((size_t)(row0 + n) * T_ + frame(d, s, lens[n])) * p.D + d;
  };
  auto stage_step = [&](int s) {
    stage_in<T>(rows, U, valid, vec,
                [&](int n) -> const T* {
                  return s < lens[n] ? dy + row_of(n, s) * H + u0 : nullptr;
                },
                [&](int n) { return dyst + (size_t)n * U; });
    stage_in<float>(rows * 6, U, valid, vec,
                    [&](int seg) -> const float* {
                      const int n = seg / 6, v = seg - n * 6;
                      if (s >= lens[n] || (v == 5 && s == 0)) return nullptr;
                      const int tf = frame(d, v == 5 ? s - 1 : s, lens[n]);
                      const size_t fr = ((size_t)d * T_ + tf) * p.R + row0 + n;
                      return saved + (fr * 5 + (v == 5 ? 4 : v)) * H + u0;
                    },
                    [&](int seg) { return svst + (size_t)seg * U; });
  };
  auto write_out = [&](int s) {
    stage_out<T>(rows * 4, U, valid, vec,
                 [&](int seg) -> T* {
                   const int n = seg >> 2;
                   if (s >= lens[n]) return nullptr;
                   return dz + row_of(n, s) * G4 + (size_t)(seg & 3) * H + u0;
                 },
                 [&](int seg) { return dzst + (size_t)seg * U; });
  };
  if (steps > 0) stage_step(steps - 1);
  cluster.sync();
  // PHASE: backward set-up: W_hh^T's slice in shared memory, zeros past the lengths.

  const int tiles = kTiles ? kTiles : rows / 8, g = lane >> 2, t = lane & 3;
  for (int s = steps - 1; s >= 0; --s) {
    // PHASE: backward frames before the last (frame 0, which has no product).
    cp_async_wait_all();
    __syncthreads();                            // the step's inputs are in
    const float* rin = recv + (size_t)((s + 1) & 1) * cs * U * rows;
    for (int i = tid; i < rows * U; i += kThreads) {
      const int n = i / U, ul = i - n * U, u = u0 + ul;
      T* dn = da + (size_t)n * MS;
      if (!(u < H && s < lens[n])) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dn[local_col(q, ul)] = from_f<T>(0.f);
        continue;
      }
      float dh = to_f(dyst[(size_t)n * U + ul]);
      if (s + 1 < steps)
        for (int src = 0; src < cs; ++src) dh += rin[((size_t)src * U + ul) * rows + n];
      const float* sv = svst + (size_t)n * 6 * U + ul;
      const float ig = sv[0], fg = sv[U], gg = sv[2 * U], og = sv[3 * U], c = sv[4 * U];
      const float cprev = s > 0 ? sv[5 * U] : 0.f;
      const float tc = tanhf(c);
      const float dc = dcs[n * U + ul] + dh * og * (1.f - tc * tc);
      const float dai = dc * gg * ig * (1.f - ig), daf = dc * cprev * fg * (1.f - fg);
      const float dag = dc * ig * (1.f - gg * gg), dao = dh * tc * og * (1.f - og);
      dcs[n * U + ul] = dc * fg;
      const T vi = from_f<T>(dai), vf = from_f<T>(daf), vg = from_f<T>(dag), vo = from_f<T>(dao);
      T* zo = dzst + (size_t)n * 4 * U + ul;
      zo[0] = vi;
      zo[U] = vf;
      zo[2 * U] = vg;
      zo[3 * U] = vo;
      dn[local_col(0, ul)] = vi;
      dn[local_col(1, ul)] = vf;
      dn[local_col(2, ul)] = vg;
      dn[local_col(3, ul)] = vo;
    }
    // PHASE: backward gate math.
    __syncthreads();
    if (s > 0) {
      // Partial dh_{t-1} over every hidden unit from this CTA's gate
      // columns; each unit's part goes to the CTA that owns it.
      float* rout = recv + (size_t)(s & 1) * cs * U * rows;
      for (int kt = warp; kt < KP / 16; kt += kWarps) {
        float acc[kMaxTiles][4] = {};
        tile_product<T, kWSmem, kTiles>(acc, wt + (size_t)16 * kt * MS, MS, da, MS, 4 * U, tiles,
                                        lane);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k = 16 * kt + g + 8 * half, j = k / U, kk = k - j * U;
          float* dst = cluster.map_shared_rank(rout, j) + ((size_t)rank * U + kk) * rows + 2 * t;
#pragma unroll
          for (int nt = 0; nt < kMaxTiles; ++nt)
            if (nt < tiles)
              *reinterpret_cast<float2*>(dst + nt * 8) =
                  make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
        }
      }
    }
    // PHASE: backward partial dh, scattered.
    cluster_arrive();
    if (s > 0) stage_step(s - 1);
    write_out(s);
    // PHASE: backward inputs in, outputs out.
    cluster_wait();
  }
  // PHASE: backward barrier.
}

template <typename K, typename... Args>
int launch(K kernel, size_t needed, const Shape& p, int smem_bytes, cudaStream_t stream,
           Args... args) {
  if (needed > (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (p.cs > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cs, p.D, (p.R + p.rows - 1) / p.rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args..., p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The kernel for the plan: in bf16 with W_hh in shared memory (the
// flagship's path) the row tiles are fixed at compile time; f32 always reads
// W_hh from scratch (its speed is not measured), as bf16 does where W_hh does
// not fit.
template <typename T>
int forward(const void* z, const void* lengths, int len64, const void* w, const void* bias,
            void* y, float* saved, void* wscratch, const Shape& p, int smem_bytes,
            cudaStream_t st) {
  auto go = [&](auto kernel) {
    return launch(kernel, forward_smem<T>(p), p, smem_bytes, st, (const T*)z, lengths, len64,
                  (const T*)w, (const T*)bias, (T*)y, saved, (T*)wscratch);
  };
  if (!p.w_in_smem) return go(lstm_forward<T, false, 0>);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return p.rows == 8 ? go(lstm_forward<T, true, 1>) : go(lstm_forward<T, true, 2>);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int backward(const void* dy, const void* lengths, int len64, const void* w, const float* saved,
             void* dz, void* wscratch, const Shape& p, int smem_bytes, cudaStream_t st) {
  auto go = [&](auto kernel) {
    return launch(kernel, backward_smem<T>(p), p, smem_bytes, st, (const T*)dy, lengths, len64,
                  (const T*)w, saved, (T*)dz, (T*)wscratch);
  };
  if (!p.w_in_smem) return go(lstm_backward<T, false, 0>);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return p.rows == 8 ? go(lstm_backward<T, true, 1>) : go(lstm_backward<T, true, 2>);
  return (int)cudaErrorInvalidValue;
}

Shape make_shape(int R, int T, int D, int H, int cs, int U, int rows, int w_in_smem) {
  Shape p;
  p.R = R;
  p.T = T;
  p.D = D;
  p.H = H;
  p.cs = cs;
  p.U = U;
  p.KP = cs * U;
  p.rows = rows;
  p.w_in_smem = w_in_smem;
  return p;
}

}  // namespace

extern "C" {

// One launch of the forward over every row and direction.  dtype: 0 float32,
// 1 bfloat16 (z, w, bias, y, wscratch); lengths [R] int64 (len64 = 1) or
// int32; saved: f32 [D, T, R, 5, H] or null.  cs, U, rows, w_in_smem and
// smem_bytes: the plan (ops/lstm_scan.py: lstm_scan_plan); wscratch: [groups,
// D, cs, 4U, cs U + 8] elements where W_hh is not in shared memory, else
// null.  Returns the cudaError_t of the launch (0 = success).
int mmav_lstm_forward_launch(int dtype, const void* z, const void* lengths, int len64,
                             const void* w, const void* bias, void* y, float* saved,
                             void* wscratch, int R, int T, int D, int H, int cs, int U, int rows,
                             int w_in_smem, int smem_bytes, void* stream) {
  const Shape p = make_shape(R, T, D, H, cs, U, rows, w_in_smem);
  if (dtype == 1)
    return forward<__nv_bfloat16>(z, lengths, len64, w, bias, y, saved, wscratch, p, smem_bytes,
                                  (cudaStream_t)stream);
  return forward<float>(z, lengths, len64, w, bias, y, saved, wscratch, p, smem_bytes,
                        (cudaStream_t)stream);
}

// One launch of the backward.  dy [R, T, D, H] and dz [R, T, D, 4H] in the
// compute dtype; saved from the forward; wscratch: [groups, D, cs, cs U,
// 4U + 8] elements where W_hh^T is not in shared memory, else null.
int mmav_lstm_backward_launch(int dtype, const void* dy, const void* lengths, int len64,
                              const void* w, const float* saved, void* dz, void* wscratch, int R,
                              int T, int D, int H, int cs, int U, int rows, int w_in_smem,
                              int smem_bytes, void* stream) {
  const Shape p = make_shape(R, T, D, H, cs, U, rows, w_in_smem);
  if (dtype == 1)
    return backward<__nv_bfloat16>(dy, lengths, len64, w, saved, dz, wscratch, p, smem_bytes,
                                   (cudaStream_t)stream);
  return backward<float>(dy, lengths, len64, w, saved, dz, wscratch, p, smem_bytes,
                         (cudaStream_t)stream);
}

const char* mmav_lstm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
