// CTC prefix beam search for Hopper (sm_90a): one CTA per utterance row, the
// frame loop inside it.
//
// Replaces no TPU kernel.  The JAX package decodes with lax.scan over frames
// (multimodal_av_model_tpu/ops/prefix_beam_search.py, the step at :57-158),
// which XLA compiles into one loop on the device.  The port's plain version of
// the same recursion (multimodal_av_model_tpu_torch/ops/prefix_beam_search.py:
// _make_step, _run) launches about 99 small kernels a frame from a Python loop,
// and the card waits on the host through nearly all of it.  This kernel runs
// the whole search, every frame of every row, in one launch.
//
// What bounds it on the H100: a serial chain of frames, not bytes.  At the
// serving shape ([8, 128, 800] f32 log-probs, 5 beams, top 8) it reads 3.3 MB,
// about 1 us at 3.35 TB/s; but frame t + 1 needs the beams of frame t, so a
// row takes its frames' count times the latency of one step (six short passes
// over 45 candidates in shared memory, each closed by __syncthreads).  The
// design keeps that step short and out of device memory:
//
// * Grid: one CTA of 256 threads per row (utterance); the rows are
//   independent.
// * Top-K first.  A frame's top-K tokens do not depend on the beams, so the
//   CTA takes them for a tile of frames at once, one warp per frame in turn,
//   into shared memory, before it walks the tile's frames one by one.  Order:
//   the stable descending sort's (on equal scores the lower token id first),
//   found as K rounds of a warp arg-max over the tokens that rank after the
//   previous round's winner.
//   The frame's blank score is staged beside them, and each new beam's
//   last-token score for the next frame is fetched while its row is copied.
// * The step, per frame: one thread per candidate (W beams x (stay + K
//   tokens)) builds it with the plain step's arithmetic (float32, the -1e30
//   sentinel, logf/expf, the optional bigram-LM bonus); equal prefixes merge
//   into their first occurrence by log-sum-exp; each candidate's rank is the
//   number of candidates with more mass, or equal mass and a lower index
//   (argsort(stable=True) without a sort); the W best become the new beams.
// * Prefix equality without comparing whole buffers: a candidate is a parent
//   beam plus an optional token, so it carries its length and a 64-bit hash of
//   its prefix, extended by one multiply-add.  Only candidates whose length
//   and hash agree are compared, against the prefix rows themselves, so a hash
//   collision cannot merge two prefixes.  Each candidate first finds the
//   lowest-index candidate of equal key (itself if none; a warp a candidate,
//   a lane an earlier one); a warp then compares the two prefixes, 32 tokens
//   a step, so each duplicate is compared once; a first occurrence sums the
//   candidates that named it.
// * Prefixes ([W, C] per row; C is T offline, up to ~1,600 frames, or a
//   stream's capacity) are double-buffered: each frame copies the chosen
//   parents' rows up to their length and clears what is left of the row it
//   overwrites, so every row stays padded with -1 past its length.  Both
//   buffers sit in shared memory where they fit (2 W C ints: 5 KB for the
//   cells, 64 KB at C = 1,600), else in device memory; the same code reads
//   either through generic pointers.
// * A row stops at its own length; the later frames are identity, as in the
//   plain step.  An empty state is built here (one live empty prefix), and the
//   best beam's ids (padded with pad_id), length and score are written at the
//   end, so an offline decode is this one launch.
// * The log-probs are read in the type they come in (f32 or bf16) and
//   widened in registers, the values .to(torch.float32) gives.  Additions
//   and products are written out (__fadd_rn, __fmul_rn) where the compiler
//   could otherwise contract them into an FMA that the plain step does not
//   make.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr float kHalfNeg = -5e29f;
constexpr unsigned long long kHashMul = 0x100000001B3ull;   // FNV-1a's 64-bit prime

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// log(e^a + e^b), safe at the sentinel: the plain step's _logaddexp.
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float ms = fmaxf(m, kHalfNeg);
  const float sum = __fadd_rn(expf(__fsub_rn(a, ms)), expf(__fsub_rn(b, ms)));
  const float out = __fadd_rn(ms, logf(sum));
  return m <= kHalfNeg ? kNeg : out;
}

// (v, i) ranks before (w, j) in the stable descending order.
__device__ __forceinline__ bool ranks_before(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Shared memory, carved in this order (the host's prefix_beam_plan counts the
// same bytes): the beams' hashes and the candidates' (8 bytes each), then the
// 4-byte arrays, the staged top-K, and the two prefix buffers if they fit.
struct Smem {
  unsigned long long *s_hash, *c_hash;
  float *s_pb, *s_pnb, *s_lplast;
  int *s_len, *s_last, *dlen, *sel;
  float *c_pb, *c_pnb, *c_mpb, *c_mpnb, *c_m;
  int *c_len, *c_par, *c_plen, *c_tok, *c_last, *c_rep, *c_grp, *collided;
  float *top_v, *top_blank;
  int *top_i, *rows;

  __device__ Smem(unsigned char* base, int W, int M, int K, int tile) {
    unsigned long long* q = reinterpret_cast<unsigned long long*>(base);
    s_hash = q; q += W;
    c_hash = q; q += M;
    float* f = reinterpret_cast<float*>(q);
    s_pb = f; f += W;
    s_pnb = f; f += W;
    s_lplast = f; f += W;
    int* n = reinterpret_cast<int*>(f);
    s_len = n; n += W;
    s_last = n; n += W;
    dlen = n; n += 2 * W;
    sel = n; n += W;
    f = reinterpret_cast<float*>(n);
    c_pb = f; f += M;
    c_pnb = f; f += M;
    c_mpb = f; f += M;
    c_mpnb = f; f += M;
    c_m = f; f += M;
    n = reinterpret_cast<int*>(f);
    c_len = n; n += M;
    c_par = n; n += M;
    c_plen = n; n += M;
    c_tok = n; n += M;
    c_last = n; n += M;
    c_rep = n; n += M;
    c_grp = n; n += M;
    collided = n; n += 1;
    top_v = reinterpret_cast<float*>(n);
    top_i = reinterpret_cast<int*>(top_v + tile * K);
    top_blank = reinterpret_cast<float*>(top_i + tile * K);
    rows = reinterpret_cast<int*>(top_blank + tile);   // 2 W C ints, if the host made room
  }
};

// Candidates i and j have equal lengths and prefix hashes: their prefixes are
// equal unless the hash collides.
__device__ __forceinline__ bool same_key(const Smem& s, int i, int j) {
  return s.c_len[i] == s.c_len[j] && s.c_hash[i] == s.c_hash[j];
}

// Token k of candidate i's prefix: its parent row of `src` (the first c_plen
// entries), then c_tok where it appends one.
__device__ __forceinline__ int token(const Smem& s, const int* src, int C, int i, int k) {
  return k < s.c_plen[i] ? src[(size_t)s.c_par[i] * C + k] : s.c_tok[i];
}

// Candidate i's prefix equals candidate j's, for two candidates of equal key,
// compared by a whole warp, 32 tokens a step.
__device__ __forceinline__ bool same_prefix_warp(const Smem& s, const int* src, int C, int i,
                                                 int j, int lane) {
  if (s.c_par[i] == s.c_par[j] && s.c_tok[i] == s.c_tok[j]) return true;
  const int L = s.c_len[i];
  for (int k0 = 0; k0 < L; k0 += 32) {
    const int k = k0 + lane;
    const bool differ = k < L && token(s, src, C, i, k) != token(s, src, C, j, k);
    if (__any_sync(0xffffffffu, differ)) return false;
  }
  return true;
}

template <typename Lp>
__global__ void __launch_bounds__(kThreads)
prefix_beam_kernel(const Lp* __restrict__ lp, const void* __restrict__ lengths, int len64,
                   const int* __restrict__ in_prefixes, const int64_t* __restrict__ in_lens,
                   const float* __restrict__ in_pb, const float* __restrict__ in_pnb,
                   const float* __restrict__ lm, int* prefixes, int* scratch,
                   int64_t* __restrict__ lens_out, float* __restrict__ pb_out,
                   float* __restrict__ pnb_out, int* __restrict__ ids,
                   int* __restrict__ out_len, float* __restrict__ score, int T, int V, int W,
                   int C, int K, int tile, int blank, int pad_id, float lm_weight,
                   float length_bonus, int rows_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = W * (K + 1);
  Smem s(smem_raw, W, M, K, tile);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Lp* lp_row = lp + (size_t)b * T * V;
  int* out_rows = prefixes + (size_t)b * W * C;
  // The current and the next frame's prefix buffers, swapped every frame.
  int* cur = rows_in_smem ? s.rows : out_rows;
  int* nxt = rows_in_smem ? s.rows + W * C : scratch + (size_t)b * W * C;

  // PHASE: the starting state (given, or one live empty prefix).
  const long long nl = len64 ? ((const int64_t*)lengths)[b] : ((const int*)lengths)[b];
  const int n = (int)(nl < 0 ? 0 : (nl > T ? T : nl));
  const bool fresh = in_prefixes == nullptr;
  const int* in_row = fresh ? nullptr : in_prefixes + (size_t)b * W * C;
  for (int k = tid; k < W * C; k += kThreads) {
    cur[k] = fresh ? -1 : in_row[k];
    nxt[k] = -1;
  }
  for (int w = tid; w < W; w += kThreads) {
    if (fresh) {
      s.s_len[w] = 0;
      s.s_last[w] = -1;
      s.s_pb[w] = w == 0 ? 0.f : kNeg;
      s.s_pnb[w] = kNeg;
      s.s_hash[w] = 0ull;
      s.dlen[w] = 0;
    } else {
      const int64_t l = in_lens[(size_t)b * W + w];
      const int len = (int)(l < 0 ? 0 : (l > C ? C : l));
      const int* r = in_row + (size_t)w * C;
      unsigned long long h = 0ull;
      for (int k = 0; k < len; ++k) h = h * kHashMul + (unsigned long long)(r[k] + 1);
      s.s_len[w] = len;
      s.s_last[w] = len > 0 ? r[len - 1] : -1;
      s.s_pb[w] = in_pb[(size_t)b * W + w];
      s.s_pnb[w] = in_pnb[(size_t)b * W + w];
      s.s_hash[w] = h;
      s.dlen[w] = C;        // a given row may hold anything past its length
    }
    s.dlen[W + w] = 0;
    s.s_lplast[w] = n > 0 && s.s_len[w] > 0 ? widen(lp_row[s.s_last[w]]) : kNeg;
  }
  int* dlen_cur = s.dlen;        // each buffer row is -1 past these lengths
  int* dlen_nxt = s.dlen + W;
  if (tid == 0) *s.collided = 0;
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += tile) {
    const int tl = min(tile, n - t0);
    // PHASE: top-K of the tile's frames, one warp per frame.
    for (int f = warp; f < tl; f += kWarps) {
      const Lp* x = lp_row + (size_t)(t0 + f) * V;
      float pv = CUDART_INF_F;
      int pi = -1;
      for (int r = 0; r < K; ++r) {
        float bv = -CUDART_INF_F;
        int bi = 0x7fffffff;
        for (int j = lane; j < V; j += 32) {
          const float v = widen(x[j]);
          if (ranks_before(pv, pi, v, j) && ranks_before(v, j, bv, bi)) {
            bv = v;
            bi = j;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (ranks_before(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (lane == 0) {
          s.top_v[f * K + r] = bv;
          s.top_i[f * K + r] = bi;
        }
        if (r == 0 && lane == 0) s.top_blank[f] = widen(x[blank]);
        pv = bv;
        pi = bi;
      }
    }
    __syncthreads();

    for (int f = 0; f < tl; ++f) {
      const Lp* x = lp_row + (size_t)(t0 + f) * V;
      const int* src = cur;
      // PHASE: candidates.  i = p * (K + 1) + k: beam p stays (k = 0) or
      // takes the frame's k-th token.
      for (int i = tid; i < M; i += kThreads) {
        const int p = i / (K + 1), k = i - p * (K + 1);
        const float pb = s.s_pb[p], pnb = s.s_pnb[p];
        const int len = s.s_len[p], last = s.s_last[p];
        const bool has_last = len > 0;
        const float total = logaddexp(pb, pnb);
        const unsigned long long h = s.s_hash[p];
        s.c_par[i] = p;
        s.c_plen[i] = len;
        s.c_grp[i] = 0;
        if (k == 0) {
          s.c_pb[i] = __fadd_rn(total, s.top_blank[f]);
          s.c_pnb[i] = __fadd_rn(pnb, s.s_lplast[p]);
          s.c_len[i] = len;
          s.c_hash[i] = h;
          s.c_tok[i] = -1;
          s.c_last[i] = last;
        } else {
          const int c = s.top_i[f * K + k - 1];
          const float pc = s.top_v[f * K + k - 1];
          const bool is_blank = c == blank;
          const float base = has_last && c == last ? pb : total;   // split vs extend
          float e = is_blank ? kNeg : __fadd_rn(base, pc);
          if (lm != nullptr) {
            const float w = lm[(size_t)(has_last ? last : V) * V + c];
            const float bonus = __fadd_rn(__fmul_rn(lm_weight, w), length_bonus);
            e = is_blank ? kNeg : __fadd_rn(e, bonus);
          }
          s.c_pb[i] = kNeg;
          s.c_pnb[i] = len >= C ? kNeg : e;
          if (len < C) {
            s.c_len[i] = len + 1;
            s.c_hash[i] = h * kHashMul + (unsigned long long)(c + 1);
            s.c_tok[i] = c;
            s.c_last[i] = c;
          } else {             // a full row cannot grow: the prefix stays
            s.c_len[i] = len;
            s.c_hash[i] = h;
            s.c_tok[i] = -1;
            s.c_last[i] = last;
          }
        }
      }
      __syncthreads();

      // PHASE: each candidate's first equal by key (its own index if none),
      // a warp a candidate, a lane an earlier one.
      for (int i = warp; i < M; i += kWarps) {
        int r = i;
        for (int j0 = 0; j0 < i; j0 += 32) {
          const int j = j0 + lane;
          const unsigned m = __ballot_sync(0xffffffffu, j < i && same_key(s, i, j));
          if (m) {
            r = j0 + __ffs(m) - 1;
            break;
          }
        }
        if (lane == 0) s.c_rep[i] = r;
      }
      __syncthreads();

      // PHASE: confirm each match against the prefixes, a warp a candidate;
      // a first occurrence learns that it heads a group.
      for (int i = warp; i < M; i += kWarps) {
        const int j = s.c_rep[i];
        if (j == i) continue;
        if (same_prefix_warp(s, src, C, i, j, lane)) {
          if (lane == 0) s.c_grp[j] = 1;
        } else if (lane == 0) {
          *s.collided = 1;
        }
      }
      __syncthreads();
      if (*s.collided) {
        // A hash collision: search again, a warp a candidate, each earlier
        // candidate of equal key compared in full until one is equal, so that
        // no collision can merge two prefixes.
        for (int i = tid; i < M; i += kThreads) s.c_grp[i] = 0;
        __syncthreads();
        for (int i = warp; i < M; i += kWarps) {
          int r = i;
          for (int j0 = 0; j0 < i && r == i; j0 += 32) {
            unsigned m = __ballot_sync(0xffffffffu, j0 + lane < i && same_key(s, i, j0 + lane));
            for (; m; m &= m - 1) {
              const int j = j0 + __ffs(m) - 1;
              if (same_prefix_warp(s, src, C, i, j, lane)) {
                r = j;
                break;
              }
            }
          }
          if (lane == 0) {
            s.c_rep[i] = r;
            if (r != i) s.c_grp[r] = 1;
          }
        }
        __syncthreads();
        if (tid == 0) *s.collided = 0;
      }

      // PHASE: merge equal prefixes into the first occurrence (log-sum-exp in
      // index order; the others keep no mass), and each candidate's total.
      for (int i = tid; i < M; i += kThreads) {
        float mpb = kNeg, mpnb = kNeg;
        if (s.c_rep[i] == i && !s.c_grp[i]) {       // alone: the plain sum of one term
          mpb = s.c_pb[i] <= kHalfNeg ? kNeg : s.c_pb[i];
          mpnb = s.c_pnb[i] <= kHalfNeg ? kNeg : s.c_pnb[i];
        } else if (s.c_rep[i] == i) {
          float xb = s.c_pb[i], xn = s.c_pnb[i];
          for (int j = i + 1; j < M; ++j)
            if (s.c_rep[j] == i) {
              xb = fmaxf(xb, s.c_pb[j]);
              xn = fmaxf(xn, s.c_pnb[j]);
            }
          const float mb = fmaxf(xb, kHalfNeg), mn = fmaxf(xn, kHalfNeg);
          float sb = expf(__fsub_rn(s.c_pb[i], mb)), sn = expf(__fsub_rn(s.c_pnb[i], mn));
          for (int j = i + 1; j < M; ++j)
            if (s.c_rep[j] == i) {
              sb = __fadd_rn(sb, expf(__fsub_rn(s.c_pb[j], mb)));
              sn = __fadd_rn(sn, expf(__fsub_rn(s.c_pnb[j], mn)));
            }
          mpb = xb <= kHalfNeg ? kNeg : __fadd_rn(mb, logf(sb));
          mpnb = xn <= kHalfNeg ? kNeg : __fadd_rn(mn, logf(sn));
        }
        s.c_mpb[i] = mpb;
        s.c_mpnb[i] = mpnb;
        s.c_m[i] = logaddexp(mpb, mpnb);
      }
      __syncthreads();

      // PHASE: stable rank; the W best become the new beams.
      for (int i = tid; i < M; i += kThreads) {
        const float mi = s.c_m[i];
        int r = 0;
        for (int j = 0; j < M; ++j) r += ranks_before(s.c_m[j], j, mi, i);
        if (r < W) s.sel[r] = i;
      }
      __syncthreads();

      // PHASE: the new beams, one warp a row: the parent's row up to its
      // length, the new token, -1 over what the row held past the new length.
      for (int r = warp; r < W; r += kWarps) {
        const int j = s.sel[r];
        const int* pr = src + (size_t)s.c_par[j] * C;
        int* dr = nxt + (size_t)r * C;
        const int lp_ = s.c_plen[j], tok = s.c_tok[j], ln = s.c_len[j];
        const int old = dlen_nxt[r];
        const int end = max(ln, old);
        for (int k = lane; k < end; k += 32) dr[k] = k < lp_ ? pr[k] : (k < ln ? tok : -1);
        __syncwarp();          // every lane has read `old` before lane 0 moves it
        if (lane == 0) {
          const bool more = t0 + f + 1 < n && ln > 0;
          s.s_lplast[r] = more ? widen(x[V + s.c_last[j]]) : kNeg;   // the next frame's
          s.s_pb[r] = s.c_mpb[j];
          s.s_pnb[r] = s.c_mpnb[j];
          s.s_len[r] = ln;
          s.s_last[r] = s.c_last[j];
          s.s_hash[r] = s.c_hash[j];
          dlen_nxt[r] = ln;
        }
      }
      int* t = cur;
      cur = nxt;
      nxt = t;
      t = dlen_cur;
      dlen_cur = dlen_nxt;
      dlen_nxt = t;
      __syncthreads();
    }
  }

  // PHASE: outputs.  The state goes to `prefixes`; the best beam's ids,
  // padded with pad_id, its length and its score.
  if (cur != out_rows)
    for (int k = tid; k < W * C; k += kThreads) out_rows[k] = cur[k];
  for (int w = tid; w < W; w += kThreads) {
    lens_out[(size_t)b * W + w] = s.s_len[w];
    pb_out[(size_t)b * W + w] = s.s_pb[w];
    pnb_out[(size_t)b * W + w] = s.s_pnb[w];
  }
  const int best = s.s_len[0];
  for (int k = tid; k < C; k += kThreads) ids[(size_t)b * C + k] = k < best ? cur[k] : pad_id;
  if (tid == 0) {
    out_len[b] = best;
    score[b] = logaddexp(s.s_pb[0], s.s_pnb[0]);
  }
}

template <typename Lp>
int launch(const void* lp, const void* lengths, int len64, const void* in_prefixes,
           const void* in_lens, const void* in_pb, const void* in_pnb, const void* lm,
           void* prefixes, void* scratch, void* lens_out, void* pb_out, void* pnb_out,
           void* ids, void* out_len, void* score, int B, int T, int V, int W, int C, int K,
           int tile, int blank, int pad_id, float lm_weight, float length_bonus,
           int rows_in_smem, int smem_bytes, cudaStream_t stream) {
  auto kernel = prefix_beam_kernel<Lp>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, kThreads, smem_bytes, stream>>>(
      (const Lp*)lp, lengths, len64, (const int*)in_prefixes, (const int64_t*)in_lens,
      (const float*)in_pb, (const float*)in_pnb, (const float*)lm, (int*)prefixes,
      (int*)scratch, (int64_t*)lens_out, (float*)pb_out, (float*)pnb_out, (int*)ids,
      (int*)out_len, (float*)score, T, V, W, C, K, tile, blank, pad_id, lm_weight,
      length_bonus, rows_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch over B rows.  dtype: 0 float32, 1 bfloat16 log-probs
// [B, T, V]; lengths [B] int64 (len64 = 1) or int32; in_*: the state
// (prefixes [B, W, C] int32, lens [B, W] int64, pb, pnb [B, W] f32), or all
// null for one live empty prefix; lm: [V + 1, V] f32 or null.  Outputs: the
// new state (prefixes, lens_out, pb_out, pnb_out), the best beam's ids [B, C]
// int32 padded with pad_id, out_len [B] int32, score [B] f32.  rows_in_smem:
// both prefix buffers sit in shared memory; else the second is scratch, a
// [B, W, C] int32 buffer.  tile: frames whose top-K are staged at once;
// smem_bytes: the launch's dynamic shared memory (ops/prefix_beam_search.py:
// prefix_beam_plan).  Returns the cudaError_t of the launch (0 = success).
int mmav_prefix_beam_launch(const void* lp, int dtype, const void* lengths, int len64,
                            const void* in_prefixes, const void* in_lens, const void* in_pb,
                            const void* in_pnb, const void* lm, void* prefixes, void* scratch,
                            void* lens_out, void* pb_out, void* pnb_out, void* ids,
                            void* out_len, void* score, int B, int T, int V, int W, int C,
                            int K, int tile, int blank, int pad_id, float lm_weight,
                            float length_bonus, int rows_in_smem, int smem_bytes,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(lp, lengths, len64, in_prefixes, in_lens, in_pb, in_pnb, lm,
                                 prefixes, scratch, lens_out, pb_out, pnb_out, ids, out_len,
                                 score, B, T, V, W, C, K, tile, blank, pad_id, lm_weight,
                                 length_bonus, rows_in_smem, smem_bytes, s);
  return launch<float>(lp, lengths, len64, in_prefixes, in_lens, in_pb, in_pnb, lm, prefixes,
                       scratch, lens_out, pb_out, pnb_out, ids, out_len, score, B, T, V, W, C,
                       K, tile, blank, pad_id, lm_weight, length_bonus, rows_in_smem,
                       smem_bytes, s);
}

const char* mmav_prefix_beam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
