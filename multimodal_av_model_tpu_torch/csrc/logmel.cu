// Fused log-mel frontend for Hopper (sm_90a): reflect-pad framing, windowed
// DFT, power, mel projection and log in one pass over the waveform.
//
// Replaces the TPU kernel multimodal_av_model_tpu/ops/pallas/logmel_kernel.py
// (log_mel_spectrogram_pallas, pallas_call at :164, body _kernel :65-107).
// The plain PyTorch version of the same function is
// multimodal_av_model_tpu_torch/ops/logmel.py:log_mel_spectrogram.
//
// What bounds it on the H100.  The function itself is bound by bytes: 1.6 MB
// of waveform in and features out at the serving shape [4, 68352], 0.49 us
// at 3.35 TB/s; an FFT (400 = 2^4 * 5^2) would need about 10 kflop a frame,
// under 0.3 us on the CUDA cores.  This kernel computes the direct DFT, the
// algorithm the TPU kernel computes: 2*400*201*2 flops per frame for re/im
// over 1,712 frames, 0.55 GFLOP, plus the mel projection over the
// filterbank's nonzeros.  The JAX kernel pins Precision.HIGHEST, so the
// products must keep f32 accuracy: plain TF32 misses the 2e-3 bar by three
// orders of magnitude, but 3xTF32 (hi/lo split, hi*hi + hi*lo + lo*hi, which
// is what HIGHEST does on the TPU's matrix unit) meets it.  At the tensor
// cores' 495/3 TFLOP/s that design bound is 3.34 us.
//
// Design: the DFT is an implicit GEMM on the tensor cores in 3xTF32, by
// wgmma (m64n56k8, f32 accumulate), the only way to the tensor cores' full
// rate on Hopper (an mma.sync version of this kernel reached an eighth of
// it: PERF.md).  Operands are
// split as hi = x rounded to tf32 (to nearest, ties away from zero: the bits
// of cvt.rna.tf32.f32, by integer add and mask) and lo = x - hi, which the
// tensor core reads truncated to tf32.
//   A[t, n] = xpad[t*hop + n] is read from the waveform span staged once in
//     shared memory, reflect padding computed here, and split in registers
//     (wgmma takes A from registers; the overlapping frames are no layout a
//     shared-memory descriptor can express).  The span is laid out in hop
//     rows of pitch hop+4 floats, so the 8 frames of an A fragment fall in 8
//     different banks (the frame stride of 160 floats is a multiple of the 32
//     banks), and a k-step of 8 never straddles a hop row (hop % 8 == 0).
//   B = [W*cos | W*sin] with re/im of one bin in neighbouring columns, so
//     c0^2 + c1^2 of an accumulator fragment is one bin's power.  The host
//     stores it f32 in the order of the shared-memory tiles (K-major core
//     matrices of 8 x 16 bytes, no swizzle); the kernel streams it through
//     registers in stages of 5 k-steps, splits it, and stores {hi, lo} tiles
//     into one of two slots while the wgmmas of the other slot run.
// Cluster plan (ops/logmel.py:logmel_plan): a cluster of 4 CTAs takes 4
// m-tiles (64 frames, the M of one wgmma); CTA r computes the DFT of all 64
// frames for its quarter of the bins (56 bins, 112 columns: 2 warpgroups of
// N = 56).  So each CTA streams only a quarter of B, and the 27 clusters
// read the 0.72 MB basis once each (19.4 MB of L2 traffic; a host-split
// basis would be twice that).  A cluster along N was chosen over TMA
// multicast along M: it needs no tensor map, and the power exchange it
// forces is 14 KB per CTA.  Each CTA pushes the power of m-tile q straight
// into the shared memory of CTA q of its cluster (distributed shared memory
// stores, which do not wait on a round trip); after one cluster barrier CTA
// r holds m-tile r's power over all bins and makes the mel projection in
// f32 FMA over each triangle's support only (16 bins at 201 bins and 80
// mels, in four independent partial sums: the dense [201, 80] product would
// be 13x the work), with the log applied in the store.  Fewer, wider
// triangles (26 mels: 38 bins at n_fft 400) take a support of 32, 48 or 64
// bins: the kernel is instantiated for each multiple of 16 (kMelChunks), so
// the 16-bin instance is the code it always was.
//
// What holds it above the design bound (tools/kernel_phases.py on the H100,
// which stamps the clock at the "PHASE:" markers below): the DFT loop takes
// about twice the tensor cores' time for its wgmmas, for a reason not yet
// found (PERF.md lists what was ruled out); staging, the cluster barrier and
// the mel step add about a third to it.
//
// The geometry below and the shared-memory carve-up are mirrored by
// ops/logmel.py:logmel_plan; the wrapper checks mmav_logmel_geometry against
// it when it loads the library, and the launch refuses a smem_bytes other
// than its own smem_layout_bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;     // CTAs per cluster = m-tiles per cluster
constexpr int kTileM = 16;      // frames per m-tile; 4 m-tiles = the 64 rows of a wgmma
constexpr int kGroups = 7;      // 8-column groups per warpgroup: wgmma N = 56
constexpr int kThreads = 256;   // 2 warpgroups
constexpr int kStageK = 5;      // k-steps (of 8) per pipeline stage
constexpr int kMelW = 16;       // bins per chunk of a mel filter's support (zero-padded)
constexpr int kMaxMelChunks = 4;  // supports of 16, 32, 48 or 64 bins
// Pitch in floats of a filter's weights: 16-byte rows, 4 floats of padding.
__host__ __device__ constexpr int mel_ld(int chunks) { return chunks * kMelW + 4; }
constexpr int kMelUnroll = 5;   // (frame, filter) pairs a thread takes at once
// One k-step of the CTA's basis: 14 groups x 2 k-cores x 8 n x 4 k, f32 in
// memory, split into {hi, lo} tiles in shared memory.
constexpr int kStepB = 2 * kGroups * 2 * 32;
constexpr int kStepFloats = 2 * kStepB;
// Pitch of a power row: the cluster's 4 x 56 bins and 4 floats of padding.
constexpr int kPmLd = kCluster * 2 * kGroups * 4 + 4;
// A warpgroup loads and splits its own half of each k-step's basis (its 7
// column groups): kHalfF4 float4, kStageK k-steps a stage.
constexpr int kHalfF4 = kStepB / 8;
constexpr int kStageHalfF4 = kStageK * kHalfF4;
constexpr int kLoadsPerThread = (kStageHalfF4 + 127) / 128;

// x rounded to tf32 (low 13 bits zero), to nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi tf32 and lo = x - hi exact; the tensor core reads
// the 19 upper bits of lo (it truncates lo to tf32), so the product keeps
// x to 2^-21 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Shared-memory matrix descriptor of a K-major tile without swizzle: core
// matrices of 8 rows x 16 bytes, 128 bytes apart along K (leading byte
// offset) and 256 bytes apart along N (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(tile);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d[64 x 56] += a[64 x 8] * B[8 x 56] for the warpgroup, tf32 in, f32
// accumulate; a is this thread's A fragment (the mma.m16n8k8 layout of its
// warp's 16 rows), B the tile behind `desc`.
__device__ __forceinline__ void wgmma_n56(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Keeps the compiler from moving reads or writes of r across wgmma's
// asynchronous use of it.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// Split cluster barrier: the arrive at the start and the wait before the
// first store to another CTA's shared memory make sure every CTA of the
// cluster is running by then.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

struct Plan {
  int S, T, n_fft, hop, pad, tiles_per_row, n_mtiles, rows_tile, n_mels, ksteps;
  float log_eps;
  int apply_log;
};

// The dynamic shared memory of a launch, in the order logmel_kernel carves
// it up: the two slots of split basis tiles, the 4 staged spans, the power
// rows, the filterbank weights (supports of `mel_width` bins) and first bins.
int smem_layout_bytes(int rows_tile, int hop, int n_mels, int mel_width) {
  return (int)sizeof(float) * (2 * kStageK * kStepFloats + kCluster * rows_tile * (hop + 4) +
                               kTileM * kPmLd + n_mels * mel_ld(mel_width / kMelW) + n_mels);
}

// Warp w of the CTA: warpgroup w / 4 (basis columns 56 (w / 4) .. + 55 of
// the CTA's 112), m-tile w % 4 of the cluster (rows 16 (w % 4) .. + 15).
// With 8 warps on the SM's 4 schedulers, instructions issued cost as much as
// tensor-core time, so the loops below carry their indices instead of
// dividing, and the split work for the next stage runs while this stage's
// wgmmas are in flight.
template <int kMelChunks>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
logmel_kernel(const float* __restrict__ sig,      // [B, S]
              const float* __restrict__ basis,    // [4, ksteps, kStepB]
              const int* __restrict__ mel_lo,     // [n_mels] first bin of filter m
              const float* __restrict__ mel_w,    // [n_mels, kMelChunks * kMelW] its weights
              float* __restrict__ out,            // [B, T, n_mels]
              Plan p) {
  constexpr int kSupport = kMelChunks * kMelW;    // bins of a filter's support
  constexpr int kMwLd = mel_ld(kMelChunks);
  extern __shared__ __align__(128) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int rank = (int)cluster.block_rank();
  const int chunk = blockIdx.x / kCluster;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2, q = warp & 3;
  // PHASE: start
  const int hp = p.hop + 4;                       // hop-row pitch, = 4 mod 32 words
  float* ring = smem;                                        // [2][kStageK][kStepFloats]
  float* raw = ring + 2 * kStageK * kStepFloats;             // [4][rows_tile][hp]
  float* pm = raw + kCluster * p.rows_tile * hp;             // [16][kPmLd]
  float* mw = pm + kTileM * kPmLd;                           // [n_mels][kMwLd]
  int* mlo = reinterpret_cast<int*>(mw + p.n_mels * kMwLd);  // [n_mels]

  // The CTA's basis streams through registers: each thread loads its
  // float4s of a stage (kStageK k-steps) from global memory, then splits
  // them into the {hi, lo} tiles of a shared-memory slot (two slots).  Each
  // warpgroup moves only the half of the tiles that its own wgmmas read, so
  // the two warpgroups synchronise only among themselves in the loop and
  // one's split work runs while the other's wgmmas do.  The basis is
  // zero-padded to whole stages (p.ksteps, a multiple of kStageK), so every
  // stage issues the same wgmmas with no branch among them (a branch there
  // makes ptxas serialise them).
  const int KS = p.n_fft / 8;
  const int n_stages = p.ksteps / kStageK;
  const int wt = threadIdx.x & 127;               // thread within the warpgroup
  const float4* bsrc = reinterpret_cast<const float4*>(basis + (size_t)rank * p.ksteps * kStepB) +
                       wg * kHalfF4;
  float4 breg[kLoadsPerThread];
  auto load_stage = [&](int s) {
#pragma unroll
    for (int j = 0; j < kLoadsPerThread; ++j) {
      const int i = wt + j * 128, u = i / kHalfF4;
      if (s < n_stages && i < kStageHalfF4)
        breg[j] = __ldg(bsrc + (size_t)(s * kStageK + u) * (kStepB / 4) + (i - u * kHalfF4));
    }
  };
  // Float4 j of the thread goes to k-step u, float e of the warpgroup's half.
  auto store_stage = [&](int s) {
#pragma unroll
    for (int j = 0; j < kLoadsPerThread; ++j) {
      const int i = wt + j * 128, u = i / kHalfF4;
      if (s < n_stages && i < kStageHalfF4) {
        const int e = (i - u * kHalfF4) * 4;
        uint32_t h[4], l[4];
        split_tf32(breg[j].x, h[0], l[0]);
        split_tf32(breg[j].y, h[1], l[1]);
        split_tf32(breg[j].z, h[2], l[2]);
        split_tf32(breg[j].w, h[3], l[3]);
        float* d = ring + ((s & 1) * kStageK + u) * kStepFloats + wg * kGroups * 64 + e;
        *reinterpret_cast<uint4*>(d) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(d + kStepB) = make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
  };
  load_stage(0);

  // 1. Stage the waveform spans of the cluster's 4 m-tiles with cp.async
  // (all CTAs of the cluster stage the same spans; warps 2qq and 2qq+1 take
  // the even and odd hop rows of m-tile qq), reflect-padded by `pad` at each
  // end (numpy/torch "reflect": the edge sample is not repeated); zeros past
  // the last frame.  The filterbank tables come the same way.
  {
    const int qq = warp >> 1;
    const int mt = chunk * kCluster + qq;
    int b = 0, t0 = 0, valid = 0;
    if (mt < p.n_mtiles) {
      b = mt / p.tiles_per_row;
      t0 = (mt - b * p.tiles_per_row) * kTileM;
      valid = (min(kTileM, p.T - t0) - 1) * p.hop + p.n_fft;
    }
    const float* x = sig + (size_t)b * p.S;
    const bool vec = (reinterpret_cast<uintptr_t>(sig) & 15) == 0 && p.S % 4 == 0 &&
                     p.pad % 4 == 0;
    for (int row = warp & 1; row < p.rows_tile; row += 2) {
      float* dst = raw + (size_t)(qq * p.rows_tile + row) * hp;
      const int s0 = (t0 + row) * p.hop - p.pad;  // source of column 0
      if (vec && s0 >= 0 && s0 + p.hop <= p.S && (row + 1) * p.hop <= valid) {
        for (int c = 4 * lane; c < p.hop; c += 128) cp_async_16(dst + c, x + s0 + c);
      } else {
        for (int col = lane; col < p.hop; col += 32) {
          if (row * p.hop + col < valid) {
            int src = s0 + col;
            if (src < 0) src = -src;
            if (src >= p.S) src = 2 * (p.S - 1) - src;
            cp_async_4(dst + col, x + src);
          } else {
            dst[col] = 0.f;
          }
        }
      }
    }
  }
  // PHASE: waveform rows issued
  for (int i = threadIdx.x; i < p.n_mels * (kSupport / 4); i += kThreads) {
    const int m = i / (kSupport / 4), c = i - m * (kSupport / 4);
    cp_async_16(mw + m * kMwLd + 4 * c, mel_w + 4 * i);
  }
  for (int m = threadIdx.x; m < p.n_mels; m += kThreads) cp_async_4(mlo + m, mel_lo + m);
  // PHASE: filterbank issued

  // 2. Stage 0 of the basis into slot 0, stage 1 into registers; then the
  // waveform, the filterbank and slot 0 are ready for every thread.
  store_stage(0);
  load_stage(1);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // A fragments of one stage (this warp's 16 frames, kStageK k-steps),
  // split into tf32 hi and lo.  The k-step's first column sits at hop row
  // arow, column acol of the staged span; (arow, acol) steps by 8 columns,
  // and stays on the last real k-step for the zero-padded ones.
  const float* aw = raw + (size_t)q * p.rows_tile * hp + g * hp + tig;
  int arow = 0, acol = 0, ka = 0;
  auto load_a = [&](uint32_t (&h)[kStageK][4], uint32_t (&l)[kStageK][4]) {
#pragma unroll
    for (int u = 0; u < kStageK; ++u) {
      const float* a = aw + arow * hp + acol;
      split_tf32(a[0], h[u][0], l[u][0]);
      split_tf32(a[8 * hp], h[u][1], l[u][1]);
      split_tf32(a[4], h[u][2], l[u][2]);
      split_tf32(a[8 * hp + 4], h[u][3], l[u][3]);
      if (++ka < KS) {
        acol += 8;
        if (acol == p.hop) { acol = 0; ++arow; }
      }
    }
  };

  // 3. DFT: per k-step, hi*hi into acc and lo*hi + hi*lo into cor, by
  // wgmma m64n56k8 with A in registers and the basis tiles in shared
  // memory.  While the wgmmas of stage s run, the thread splits its share
  // of stage s + 1 into the other slot, loads stage s + 2 and the A
  // fragments of stage s + 1, and only then waits for the wgmmas.  Nothing
  // is issued between the wgmmas themselves, and the A fragments of
  // neighbouring stages live in two fixed register sets (the loop takes two
  // stages a turn), so no instruction writes a register that a wgmma in
  // flight reads: either would make ptxas serialise the wgmmas.
  float acc[28], cor[28];
#pragma unroll
  for (int i = 0; i < 28; ++i) acc[i] = cor[i] = 0.f;
  using Frag = uint32_t[kStageK][4];
  auto stage = [&](int s, Frag& ah, Frag& al, Frag& nh, Frag& nl) {
    const float* tiles = ring + (s & 1) * kStageK * kStepFloats + wg * kGroups * 64;
#pragma unroll
    for (int i = 0; i < 28; ++i) { fence_operand(acc[i]); fence_operand(cor[i]); }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < kStageK; ++u) {
      const float* t = tiles + u * kStepFloats;
      const uint64_t bh = b_desc(t), bl = b_desc(t + kStepB);
      wgmma_n56(cor, al[u], bh);
      wgmma_n56(cor, ah[u], bl);
      wgmma_n56(acc, ah[u], bh);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    store_stage(s + 1);              // into the slot stage s - 1 used
    load_stage(s + 2);
    load_a(nh, nl);                  // stage s + 1 (past the last one: unused)
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 28; ++i) { fence_operand(acc[i]); fence_operand(cor[i]); }
#pragma unroll
    for (int u = 0; u < kStageK; ++u)
#pragma unroll
      for (int i = 0; i < 4; ++i) { fence_operand(ah[u][i]); fence_operand(al[u][i]); }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");   // this warpgroup only
  };
  Frag a0h, a0l, a1h, a1l;
  // PHASE: basis stage 0 stored, all staged
  load_a(a0h, a0l);
  for (int s = 0; s < n_stages; s += 2) {       // n_stages is even
    stage(s, a0h, a0l, a1h, a1l);
    stage(s + 1, a1h, a1l, a0h, a0l);
  }
  // PHASE: first A split + DFT (wgmma loop)

  // 4. Power of this warp's m-tile q into CTA q's power rows: re, im of bin
  // 4i + tig of column group i sit in columns 2tig, 2tig+1.
  cluster_wait();
  {
    float* dst = cluster.map_shared_rank(pm, q);
    const int col0 = (rank * 2 + wg) * kGroups * 4 + tig;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[4 * i + e] + cor[4 * i + e];
      dst[g * kPmLd + col0 + 4 * i] = v[0] * v[0] + v[1] * v[1];
      dst[(g + 8) * kPmLd + col0 + 4 * i] = v[2] * v[2] + v[3] * v[3];
    }
  }
  // PHASE: power pushed
  cluster.sync();                 // all power rows have landed
  // PHASE: cluster barrier

  // 5. Mel projection in f32 over each filter's support (kSupport contiguous
  // bins from mel_lo, zero-weighted past the triangle), in four independent
  // partial sums; log in the store.  Thread i takes (frame, filter) pairs
  // i, i + 256, ... of the m-tile, kMelUnroll of them at a time.
  const int mt = chunk * kCluster + rank;
  if (mt >= p.n_mtiles) return;
  const int b = mt / p.tiles_per_row;
  const int t0 = (mt - b * p.tiles_per_row) * kTileM;
  const int total = min(kTileM, p.T - t0) * p.n_mels;
  const float inv_mels = 1.f / (float)p.n_mels;
  float* obase = out + ((size_t)b * p.T + t0) * p.n_mels;
  for (int i0 = threadIdx.x; i0 < total; i0 += kMelUnroll * kThreads) {
#pragma unroll
    for (int j = 0; j < kMelUnroll; ++j) {
      const int i = i0 + j * kThreads;
      if (i < total) {
        const int t = (int)(((float)i + 0.5f) * inv_mels), m = i - t * p.n_mels;
        const float* pr = pm + t * kPmLd + mlo[m];
        const float4* w = reinterpret_cast<const float4*>(mw + m * kMwLd);
        float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < kSupport / 4; ++k) {
          const float4 wk = w[k];
          v[0] = fmaf(pr[4 * k], wk.x, v[0]);
          v[1] = fmaf(pr[4 * k + 1], wk.y, v[1]);
          v[2] = fmaf(pr[4 * k + 2], wk.z, v[2]);
          v[3] = fmaf(pr[4 * k + 3], wk.w, v[3]);
        }
        const float e = (v[0] + v[1]) + (v[2] + v[3]);
        obase[i] = p.apply_log ? logf(e + p.log_eps) : e;
      }
    }
  }
  // PHASE: mel projection + log
}

// The instance whose mel supports are kMelChunks x 16 bins, on `stream`.
template <int kMelChunks>
int launch(const void* sig, const void* basis, const void* mel_lo, const void* mel_w,
           void* out, const Plan& p, int ctas, int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<kMelChunks>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  logmel_kernel<kMelChunks><<<ctas, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)sig, (const float*)basis, (const int*)mel_lo, (const float*)mel_w,
      (float*)out, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel's fixed geometry, for the wrapper to check ops/logmel.py's
// plan against: CTAs per cluster, frames per m-tile, 8-column n-tiles per
// CTA, k-steps per pipeline stage, the bins a mel support is a multiple of,
// threads per CTA.
void mmav_logmel_geometry(int* g) {
  g[0] = kCluster;
  g[1] = kTileM;
  g[2] = 2 * kGroups;
  g[3] = kStageK;
  g[4] = kMelW;
  g[5] = kThreads;
}

// Launches on `stream` with the plan of ops/logmel.py:logmel_plan: `ctas`
// CTAs (a multiple of 4) of 256 threads, `smem_bytes` of dynamic shared
// memory (opted in above 48 KB here), and the instance whose mel supports
// are `mel_width` bins (16, 32, 48 or 64).  Returns cudaErrorInvalidValue if
// the plan's `ctas`, `mel_width` or `smem_bytes` are not the kernel's, else
// the cudaError_t of the attribute call or of the launch (0 = success).
int mmav_logmel_launch(const void* sig, const void* basis, const void* mel_lo,
                       const void* mel_w, void* out, int S, int T, int n_fft, int hop,
                       int pad, int tiles_per_row, int n_mtiles, int rows_tile, int n_mels,
                       int ksteps, int mel_width, float log_eps, int apply_log, int ctas,
                       int smem_bytes, void* stream) {
  const int chunks = mel_width / kMelW;
  if (ctas % kCluster != 0 || mel_width % kMelW != 0 || chunks < 1 || chunks > kMaxMelChunks ||
      smem_bytes != smem_layout_bytes(rows_tile, hop, n_mels, mel_width))
    return (int)cudaErrorInvalidValue;
  const Plan p{S, T, n_fft, hop, pad, tiles_per_row, n_mtiles, rows_tile, n_mels,
               ksteps, log_eps, apply_log};
  switch (chunks) {
    case 1: return launch<1>(sig, basis, mel_lo, mel_w, out, p, ctas, smem_bytes, stream);
    case 2: return launch<2>(sig, basis, mel_lo, mel_w, out, p, ctas, smem_bytes, stream);
    case 3: return launch<3>(sig, basis, mel_lo, mel_w, out, p, ctas, smem_bytes, stream);
    default: return launch<4>(sig, basis, mel_lo, mel_w, out, p, ctas, smem_bytes, stream);
  }
}

const char* mmav_logmel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
