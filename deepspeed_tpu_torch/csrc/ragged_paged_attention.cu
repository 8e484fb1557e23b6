// Ragged paged attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel deepspeed_tpu/ops/transformer/decode_attention.py:
// _ragged_kernel (pallas_call in ragged_paged_attention). It computes the
// same function: for row r of a [R, W] token window, query slot w sits at
// absolute position q_pos = kv_len[r] - q_len[r] + w and attends to the keys
// kv_pos <= q_pos with kv_pos < kv_len[r], read through the row's page table
// (ids clamped into [0, NP)) out of a shared pool [NP, NKV, P, D]; the NH / NKV
// query heads of a kv head share its keys (GQA). q/k/v are read in their dtype
// and used as fp32 values; scores, the softmax (finite NEG_INF = -1e30 masking)
// and P.V accumulate in fp32 with the scale; the output is written in q's
// dtype. Rows with kv_len == 0, and window slots w >= q_len, are written as
// exact zeros.
//
// What bounds it: memory. Per query head it does 4*D flops for every key
// (2*D bytes of K and V in bf16), far below the card's ~295 flops/byte balance
// point, so the least time is the bytes of q, the output and the LIVE K/V pages
// over HBM bandwidth (2-3 us at the serving shapes).
//
// Design (flash-decoding: split-KV with an in-order combine):
//  * the grid is (split, kv head, row): each row's keys are cut into splits of
//    SPLIT = 128 keys, and the number of splits, ceil(MAXP * P / SPLIT), comes
//    from the shapes alone (no kv_lens on the host: no sync, and the step can
//    be captured in a CUDA graph). At the W=1 serving shape that is 16 x 4 x 8 =
//    512 blocks on 132 SMs instead of 32;
//  * a block serves every live query row of its (row, kv head) group, W*Hg rows
//    (slot-major: row i is slot i / Hg of head g*Hg + i % Hg), from ONE staged
//    copy of its split's K and V: the split's two 64-key tiles are copied into
//    shared memory by 16-byte cp.async (page ids looked up per staged key row,
//    so a tile may span pages or cover part of one; keys at or past kv_len are
//    zero-filled), one commit group each, so the first tile's products start
//    while the second is in flight; the query rows then run in chunks over the
//    resident tiles, and K/V are read from HBM once per (row, kv head, split);
//  * each block writes, for every live query row, a partial (m, l, acc): the
//    row's max scaled score in the split, the sum of exp(s - m) and the
//    unnormalised exp(s - m) . V. A split that starts at or past kv_len (or a
//    row with no visible key in the split) writes the empty partial
//    m = NEG_INF, l = 0; a dead row writes nothing;
//  * a second kernel merges a slot's partials in split order (M = max m,
//    L = sum exp(m - M) l, O = sum exp(m - M) acc / L, empty partials
//    skipped): no atomics, so the result is bitwise deterministic. It writes
//    the exact zeros of dead rows and slots. The fp32 workspace is sized from
//    the shapes by the wrapper (torch.empty, reused by the caching allocator).
// Arithmetic:
//  * fp32 (the card's parity path, kernel vs plain to about 1e-6 with TF32
//    off) runs on FMAs in chunks of 16 query rows: a thread per key of the
//    64-key tile computes its scores against 8 rows with float4 reads of the
//    swizzled tiles (conflict-free), a warp per row runs the online softmax,
//    and in P.V a thread owns one column of 8 (D = 64) or 16 (D = 128) rows,
//    reading each V value once for all of them;
//  * bf16 / fp16 run on mma.sync.m16n8k16 (csrc/tensor_core.cuh), 4 warps of
//    16 query rows a chunk of 64: Q.K^T takes the operands as stored (a bf16 x
//    bf16 product is exact in fp32, so only the order of summation changes);
//    the online softmax stays in fp32 registers (base 2, scale in one FMA).
//    P is fp32 in the reference (decode_attention.py:223-243), so P.V runs as
//    two products, P = hi + lo each rounded to the operand type (about 2^-16 of
//    P instead of 2^-8), the hi/lo split that K9 uses; V is exact in its own
//    dtype. Tensor cores rather than FMA here because a W=32 prefill group is
//    256 query rows x 128 keys a block, which FMAs take ~40 us per block on.
// Only D = 64 and D = 128 are built; any Hg = NH / NKV and any page size P work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SPLIT = 128;      // keys of a split
constexpr int KT = 64;          // keys of a staged tile (one cp.async group)
constexpr int NT = SPLIT / KT;  // tiles of a split
constexpr int THREADS = 128;    // four warps
constexpr int QC_TC = 64;       // query rows of a chunk, tensor cores: 16 a warp
constexpr int QC_FMA = 16;      // query rows of a chunk, fp32 FMA
static_assert(NT == 2, "the tile waits below assume two tiles a split");

// element offset of (row, col) in a tile of rows of D values of T, whose 16-byte chunks are
// swizzled by the row (chunk c of row r at c ^ (r & 7)); col is a multiple of 16 / sizeof(T).
// For 16-bit T this is tc::swz<D>.
template <typename T, int D>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int E = 16 / sizeof(T);
  return row * D + (((col / E) ^ (row & 7)) * E);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// what a block of the split kernel needs to know about its (row, kv head, split)
struct Group {
  const int* pt_row;  // the row's page table
  int r, g, Hg, NH, NKV, NP, P, MAXP, W;
  int kv_len, start;  // start = kv_len - q_len: slot w sits at start + w
  int n_live;         // live query rows: min(q_len, W) * Hg (slot-major)
  int s0;             // the split's first key
};

// async copy of keys base .. base+63 of the group's kv head into swizzled [64][D] tiles of K and
// V; keys at or past kv_len are zero-filled
template <typename T, int D>
__device__ __forceinline__ void stage_kv(T* ks, T* vs, const T* __restrict__ k_pages,
                                         const T* __restrict__ v_pages, const Group& G, int base) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CH = D / E;  // 16-byte chunks of a row
#pragma unroll
  for (int i = 0; i < KT * CH / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int row = e / CH, c = e % CH;
    const int pos = base + row;
    const bool valid = pos < G.kv_len;
    size_t off = 0;
    if (valid) {
      const int slot = pos / G.P;
      int pid = slot < G.MAXP ? G.pt_row[slot] : 0;
      pid = min(max(pid, 0), G.NP - 1);
      off = ((static_cast<size_t>(pid) * G.NKV + G.g) * G.P + pos % G.P) * D + c * E;
    }
    tc::cp_async16(ks + swz<T, D>(row, c * E), k_pages + off, valid);
    tc::cp_async16(vs + swz<T, D>(row, c * E), v_pages + off, valid);
  }
}

// async copy of query rows i0 .. i0+QC-1 of the group into a swizzled [QC][D] tile; rows at or
// past n_live are zero-filled
template <typename T, int D, int QC>
__device__ __forceinline__ void stage_q(T* qs, const T* __restrict__ q, const Group& G, int i0) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CH = D / E;
  for (int e = threadIdx.x; e < QC * CH; e += THREADS) {
    const int row = e / CH, c = e % CH;
    const int i = i0 + row;
    const bool valid = i < G.n_live;
    size_t off = 0;
    if (valid) {
      const int w = i / G.Hg, h = G.g * G.Hg + i % G.Hg;
      off = ((static_cast<size_t>(G.r) * G.W + w) * G.NH + h) * D + c * E;
    }
    tc::cp_async16(qs + swz<T, D>(row, c * E), q + off, valid);
  }
}

// tile t of the split has landed (the copies were committed as group 0 = Q + tile 0, group 1 =
// tile 1) and every thread sees it
__device__ __forceinline__ void wait_tile(int t) {
  if (t == 0)
    tc::cp_async_wait<1>();
  else
    tc::cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------------------------
// the split kernel: partials (m, l, acc) of every live query row of (row r, kv head g, split s)
// ---------------------------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
ragged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ page_table,
                    const int* __restrict__ kv_lens, const int* __restrict__ q_lens,
                    float2* __restrict__ ws_ml, float* __restrict__ ws_acc, int W, int NH, int NKV,
                    int NP, int P, int MAXP, int nsplit, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Group G;
  G.r = blockIdx.z;
  G.g = blockIdx.y;
  G.Hg = NH / NKV;
  G.NH = NH, G.NKV = NKV, G.NP = NP, G.P = P, G.MAXP = MAXP, G.W = W;
  G.pt_row = page_table + static_cast<size_t>(G.r) * MAXP;
  G.kv_len = kv_lens[G.r];
  const int q_len = q_lens[G.r];
  G.start = G.kv_len - q_len;
  G.n_live = G.kv_len > 0 ? min(max(q_len, 0), W) * G.Hg : 0;
  G.s0 = blockIdx.x * SPLIT;
  if (G.n_live == 0) return;  // the combine writes this row's zeros and reads nothing of it
  const int Wq = W * G.Hg;
  const size_t base = ((static_cast<size_t>(G.r) * NKV + G.g) * nsplit + blockIdx.x) * Wq;
  float2* ml = ws_ml + base;
  float* acc = ws_acc + base * D;
  if (G.s0 >= G.kv_len) {  // past every live key: the empty partial
    for (int i = threadIdx.x; i < G.n_live; i += THREADS) ml[i] = make_float2(NEG_INF, 0.f);
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* ks = reinterpret_cast<T*>(smem_raw);  // [SPLIT][D]
  T* vs = ks + SPLIT * D;                  // [SPLIT][D]
  T* qs = vs + SPLIT * D;                  // [QC][D]

  if constexpr (std::is_same<T, float>::value) {
    // ---- fp32: FMA ----
    constexpr int QC = QC_FMA;
    constexpr int SP = KT + 1;              // padded score row
    constexpr int ACC = QC * D / THREADS;   // output elements a thread
    float* ps = qs + QC * D;                // [QC][SP] scores, then probabilities
    float* m_s = ps + QC * SP;              // [QC]
    float* l_s = m_s + QC;
    float* corr_s = l_s + QC;
    stage_q<T, D, QC>(qs, q, G, 0);
    stage_kv<T, D>(ks, vs, k_pages, v_pages, G, G.s0);
    tc::cp_async_commit();
    if (G.s0 + KT < G.kv_len) stage_kv<T, D>(ks + KT * D, vs + KT * D, k_pages, v_pages, G, G.s0 + KT);
    tc::cp_async_commit();

    const int n_chunks = (G.n_live + QC - 1) / QC;
    for (int c = 0; c < n_chunks; ++c) {
      const int i0 = c * QC;
      if (c > 0) {
        __syncthreads();  // every thread is done with chunk c - 1's Q, scores and statistics
        stage_q<T, D, QC>(qs, q, G, i0);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
      }
      if (threadIdx.x < QC) {
        m_s[threadIdx.x] = NEG_INF;
        l_s[threadIdx.x] = 0.f;
      }
      if (c > 0) __syncthreads();
      float o[ACC];
#pragma unroll
      for (int a = 0; a < ACC; ++a) o[a] = 0.f;
      // the largest position among the chunk's live rows
      const int qpos_hi = G.start + (min(i0 + QC, G.n_live) - 1) / G.Hg;
      for (int t = 0; t < NT; ++t) {
        if (c == 0) wait_tile(t);
        const int k0 = G.s0 + t * KT;
        if (k0 >= G.kv_len || k0 > qpos_hi) break;  // block-uniform: no live pair in this tile
        const int nk = min(KT, G.kv_len - k0);
        const T* kt_s = ks + t * KT * D;
        const T* vt_s = vs + t * KT * D;
        // scores: thread = (key j, half hr of the chunk's rows)
        {
          const int j = threadIdx.x & (KT - 1), hr = threadIdx.x / KT;
          float sc[QC / 2];
#pragma unroll
          for (int rr = 0; rr < QC / 2; ++rr) sc[rr] = 0.f;
#pragma unroll 4
          for (int d = 0; d < D; d += 4) {
            const float4 kv = *reinterpret_cast<const float4*>(kt_s + swz<T, D>(j, d));
#pragma unroll
            for (int rr = 0; rr < QC / 2; ++rr) {
              const float4 qv = *reinterpret_cast<const float4*>(qs + swz<T, D>(hr * (QC / 2) + rr, d));
              sc[rr] = fmaf(qv.x, kv.x, sc[rr]);
              sc[rr] = fmaf(qv.y, kv.y, sc[rr]);
              sc[rr] = fmaf(qv.z, kv.z, sc[rr]);
              sc[rr] = fmaf(qv.w, kv.w, sc[rr]);
            }
          }
          const int kv_pos = k0 + j;
#pragma unroll
          for (int rr = 0; rr < QC / 2; ++rr) {
            const int row = hr * (QC / 2) + rr, i = i0 + row;
            const bool live = i < G.n_live && kv_pos < G.kv_len && kv_pos <= G.start + i / G.Hg;
            ps[row * SP + j] = live ? sc[rr] * scale : NEG_INF;
          }
        }
        __syncthreads();
        // online softmax, a warp per row. A masked entry contributes p = 0 even while the
        // running max is still NEG_INF, so a tile whose keys are all masked for a row never
        // turns exp(m - m) into ones.
        for (int row = warp; row < QC; row += THREADS / 32) {
          const int i = i0 + row;
          const float s_a = ps[row * SP + lane], s_b = ps[row * SP + lane + 32];
          const float mx = warp_max(fmaxf(s_a, s_b));
          const float m_prev = m_s[row];
          const float m_new = fmaxf(m_prev, mx);
          float sum = 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = lane + 32 * half;
            const int kv_pos = k0 + j;
            const bool live = i < G.n_live && kv_pos < G.kv_len && kv_pos <= G.start + i / G.Hg;
            const float p = live ? expf((half ? s_b : s_a) - m_new) : 0.f;
            ps[row * SP + j] = p;
            sum += p;
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            const float corr = expf(m_prev - m_new);
            corr_s[row] = corr;
            l_s[row] = l_s[row] * corr + sum;
            m_s[row] = m_new;
          }
        }
        __syncthreads();
        // o = o * corr + P.V over the tile's live keys. A thread's outputs share one column d
        // (rows row0 + a * THREADS / D), so each key's V value is read once for all of them and
        // the ACC sums are independent chains.
        {
          constexpr int RSTEP = THREADS / D;
          const int d = threadIdx.x % D, row0 = threadIdx.x / D;
#pragma unroll
          for (int a = 0; a < ACC; ++a) o[a] *= corr_s[row0 + a * RSTEP];
#pragma unroll 4
          for (int jj = 0; jj < nk; ++jj) {
            const float vv = vt_s[jj * D + (d ^ ((jj & 7) << 2))];  // swz<T, D>(jj, d & ~3) + (d & 3)
#pragma unroll
            for (int a = 0; a < ACC; ++a) o[a] = fmaf(ps[(row0 + a * RSTEP) * SP + jj], vv, o[a]);
          }
        }
        __syncthreads();  // the next tile's scores overwrite ps
      }
      __syncthreads();
      // the chunk's partials
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int e = threadIdx.x + a * THREADS;
        const int row = e / D, d = e % D;
        if (i0 + row < G.n_live && l_s[row] > 0.f) acc[static_cast<size_t>(i0 + row) * D + d] = o[a];
      }
      if (threadIdx.x < QC && i0 + threadIdx.x < G.n_live) {
        const float l = l_s[threadIdx.x];
        ml[i0 + threadIdx.x] = l > 0.f ? make_float2(m_s[threadIdx.x], l) : make_float2(NEG_INF, 0.f);
      }
    }
    tc::cp_async_wait<0>();
  } else {
    // ---- bf16 / fp16: mma.sync ----
    constexpr int QC = QC_TC;
    constexpr int KS = D / 16;  // k16 steps of Q K^T
    constexpr int DT = D / 8;   // 8-wide output tiles
    const int g4 = lane >> 2, t4 = lane & 3;
    const float sl2 = scale * LOG2E;
    stage_q<T, D, QC>(qs, q, G, 0);
    stage_kv<T, D>(ks, vs, k_pages, v_pages, G, G.s0);
    tc::cp_async_commit();
    if (G.s0 + KT < G.kv_len) stage_kv<T, D>(ks + KT * D, vs + KT * D, k_pages, v_pages, G, G.s0 + KT);
    tc::cp_async_commit();

    const int n_chunks = (G.n_live + QC - 1) / QC;
    for (int c = 0; c < n_chunks; ++c) {
      if (c > 0) {
        __syncthreads();  // every warp is done with chunk c - 1's Q tile
        stage_q<T, D, QC>(qs, q, G, c * QC);
        tc::cp_async_commit();
        tc::cp_async_wait<0>();
        __syncthreads();
      }
      const int i0 = c * QC + warp * 16;  // this warp's rows: i0 + g4 and i0 + g4 + 8
      const bool warp_live = i0 < G.n_live;
      const int qpos_lo = G.start + i0 / G.Hg;
      const int qpos_hi = G.start + (min(i0 + 16, G.n_live) - 1) / G.Hg;
      uint32_t qf[KS][4];
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // unscaled running max; this lane's share of l
      float o[DT][4];
#pragma unroll
      for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
      for (int t = 0; t < NT; ++t) {
        if (c == 0) wait_tile(t);
        if (t == 0 && warp_live) {
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            tc::ldmatrix_x4(qf[kk], qs + tc::swz<D>(warp * 16 + (lane & 15), kk * 16 + (lane >> 4) * 8));
        }
        const int k0 = G.s0 + t * KT;
        if (!warp_live || k0 >= G.kv_len || k0 > qpos_hi) continue;  // warp-uniform: no live pair
        const T* kt_s = ks + t * KT * D;
        const T* vt_s = vs + t * KT * D;
        // S = Q K^T: 8 tiles of 16 x 8 scores
        float s[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bf[4];
            tc::ldmatrix_x4(bf, kt_s + tc::swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                                  kk * 16 + ((lane >> 3) & 1) * 8));
            tc::mma<T>(s[2 * np], qf[kk], bf[0], bf[1]);
            tc::mma<T>(s[2 * np + 1], qf[kk], bf[2], bf[3]);
          }
        }
        // online softmax; only tiles that cross a row's diagonal, kv_len or the live rows' end
        // are masked
        const bool masked = k0 + KT - 1 > qpos_lo || k0 + KT > G.kv_len || i0 + 16 > G.n_live;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (masked) {
              const int i = i0 + g4 + (e >> 1) * 8, kv_pos = k0 + j * 8 + 2 * t4 + (e & 1);
              if (!(i < G.n_live && kv_pos < G.kv_len && kv_pos <= G.start + i / G.Hg)) s[j][e] = NEG_INF;
            }
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        float corr[2], msl[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          corr[i] = ex2((m[i] - mx[i]) * sl2);
          m[i] = mx[i];
          l[i] *= corr[i];
          msl[i] = mx[i] * sl2;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // NEG_INF is finite: on a row whose every score so far is masked, exp(s - m) would
            // be 1, so masked probabilities are zeroed explicitly
            float p = ex2(fmaf(s[j][e], sl2, -msl[e >> 1]));
            if (masked && s[j][e] == NEG_INF) p = 0.f;
            s[j][e] = p;
            l[e >> 1] += p;
          }
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          o[j][0] *= corr[0];
          o[j][1] *= corr[0];
          o[j][2] *= corr[1];
          o[j][3] *= corr[1];
        }
        // o += P V with the fp32 P as hi + lo in the operand type; B from V by ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          uint32_t ph[4], pl[4];
          tc::a_from_c_split<T>(ph, pl, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t bf[4];
            tc::ldmatrix_x4_trans(bf, vt_s + tc::swz<D>(kk * 16 + (lane & 15), dp * 16 + (lane >> 4) * 8));
            tc::mma<T>(o[2 * dp], ph, bf[0], bf[1]);
            tc::mma<T>(o[2 * dp + 1], ph, bf[2], bf[3]);
            tc::mma<T>(o[2 * dp], pl, bf[0], bf[1]);
            tc::mma<T>(o[2 * dp + 1], pl, bf[2], bf[3]);
          }
        }
      }
      // the chunk's partials: m in scaled-score units, so that p = exp(scale s - m)
      if (warp_live) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float lh = l[h];
          lh += __shfl_xor_sync(0xffffffffu, lh, 1);
          lh += __shfl_xor_sync(0xffffffffu, lh, 2);
          const int i = i0 + g4 + h * 8;
          if (i < G.n_live) {
            if (t4 == 0) ml[i] = lh > 0.f ? make_float2(m[h] * scale, lh) : make_float2(NEG_INF, 0.f);
            if (lh > 0.f) {
              float* dst = acc + static_cast<size_t>(i) * D + 2 * t4;
#pragma unroll
              for (int j = 0; j < DT; ++j)
                *reinterpret_cast<float2*>(dst + j * 8) = make_float2(o[j][2 * h], o[j][2 * h + 1]);
            }
          }
        }
      }
    }
    tc::cp_async_wait<0>();
  }
}

// ---------------------------------------------------------------------------------------------
// the combine: one warp per output row (r, w, h), the partials merged in split order
// ---------------------------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
ragged_combine_kernel(const float2* __restrict__ ws_ml, const float* __restrict__ ws_acc,
                      const int* __restrict__ kv_lens, const int* __restrict__ q_lens,
                      T* __restrict__ out, int R, int W, int NH, int NKV, int nsplit) {
  constexpr int V = D / 32;  // output values a lane
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(R) * W * NH) return;
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(row % NH);
  const int w = static_cast<int>((row / NH) % W);
  const int r = static_cast<int>(row / (static_cast<long long>(NH) * W));
  const int kv_len = kv_lens[r], q_len = q_lens[r];
  float o[V];
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = 0.f;
  if (kv_len > 0 && w < q_len) {
    const int Hg = NH / NKV, g = h / Hg, Wq = W * Hg;
    const size_t first = (static_cast<size_t>(r) * NKV + g) * nsplit * Wq + w * Hg + h % Hg;
    float M = NEG_INF;
    for (int s = 0; s < nsplit; ++s) {
      const float2 p = ws_ml[first + static_cast<size_t>(s) * Wq];
      if (p.y > 0.f) M = fmaxf(M, p.x);
    }
    float L = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t at = first + static_cast<size_t>(s) * Wq;
      const float2 p = ws_ml[at];
      if (p.y > 0.f) {  // empty partials are skipped: their acc was never written
        const float wgt = expf(p.x - M);
        L += wgt * p.y;
        const float* a = ws_acc + at * D + lane * V;
#pragma unroll
        for (int k = 0; k < V; ++k) o[k] += wgt * a[k];
      }
    }
    const float safe_l = L == 0.f ? 1.f : L;
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] /= safe_l;
  }
  T* dst = out + row * D + lane * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if constexpr (std::is_same<T, float>::value)
      dst[k] = o[k];
    else if constexpr (std::is_same<T, __nv_bfloat16>::value)
      dst[k] = __float2bfloat16(o[k]);
    else
      dst[k] = __float2half(o[k]);
  }
}

template <typename T, int D>
constexpr size_t split_smem() {
  if constexpr (std::is_same<T, float>::value)  // K, V, Q; scores; m, l, corr
    return sizeof(float) * ((2 * SPLIT + QC_FMA) * D + QC_FMA * (KT + 1) + 3 * QC_FMA);
  else
    return sizeof(T) * (2 * SPLIT + QC_TC) * D;
}

template <typename T, int D>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* page_table,
           const void* kv_lens, const void* q_lens, void* out, void* ws_ml, void* ws_acc, int R, int W,
           int NH, int NKV, int NP, int P, int MAXP, int nsplit, float scale, cudaStream_t stream) {
  constexpr size_t smem = split_smem<T, D>();
  auto split = ragged_split_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  split<<<dim3(nsplit, NKV, R), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_lens), static_cast<float2*>(ws_ml), static_cast<float*>(ws_acc), W,
      NH, NKV, NP, P, MAXP, nsplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(R) * W * NH;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  ragged_combine_kernel<T, D><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const float2*>(ws_ml), static_cast<const float*>(ws_acc),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_lens), static_cast<T*>(out), R, W,
      NH, NKV, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int D, const void* q, const void* k_pages, const void* v_pages,
               const void* page_table, const void* kv_lens, const void* q_lens, void* out,
               void* ws_ml, void* ws_acc, int R, int W, int NH, int NKV, int NP, int P, int MAXP,
               int nsplit, float scale, cudaStream_t stream) {
  if (D == 64)
    return launch<T, 64>(q, k_pages, v_pages, page_table, kv_lens, q_lens, out, ws_ml, ws_acc, R, W,
                         NH, NKV, NP, P, MAXP, nsplit, scale, stream);
  if (D == 128)
    return launch<T, 128>(q, k_pages, v_pages, page_table, kv_lens, q_lens, out, ws_ml, ws_acc, R,
                          W, NH, NKV, NP, P, MAXP, nsplit, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Keys a split holds: the wrapper sizes the workspace from it, nsplit = ceil(MAXP * P / split).
extern "C" int ragged_paged_attention_split_keys() { return SPLIT; }

// dtype: 0 float32, 1 bfloat16, 2 float16. ws_ml holds R*NKV*nsplit*W*(NH/NKV) float2 and ws_acc
// D times as many floats, nsplit = ceil(MAXP * P / split_keys); their contents on entry do not
// matter. Runs the split kernel and the combine on `stream`; returns the first non-zero
// cudaError_t of the two launches (0 = both launched); does not synchronise.
extern "C" int ragged_paged_attention(int dtype, const void* q, const void* k_pages,
                                      const void* v_pages, const void* page_table,
                                      const void* kv_lens, const void* q_lens, void* out,
                                      void* ws_ml, void* ws_acc, int R, int W, int NH, int NKV,
                                      int NP, int P, int D, int MAXP, int nsplit, float scale,
                                      void* stream) {
  if (R <= 0 || W <= 0 || NKV <= 0 || NH % NKV != 0 || P <= 0 || NP <= 0 || MAXP <= 0 ||
      (D != 64 && D != 128) || R > 65535 || NKV > 65535 ||
      static_cast<long long>(nsplit) * SPLIT < static_cast<long long>(MAXP) * P || nsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dim<float>(D, q, k_pages, v_pages, page_table, kv_lens, q_lens, out, ws_ml,
                               ws_acc, R, W, NH, NKV, NP, P, MAXP, nsplit, scale, s);
    case 1:
      return launch_dim<__nv_bfloat16>(D, q, k_pages, v_pages, page_table, kv_lens, q_lens, out,
                                       ws_ml, ws_acc, R, W, NH, NKV, NP, P, MAXP, nsplit, scale, s);
    case 2:
      return launch_dim<__half>(D, q, k_pages, v_pages, page_table, kv_lens, q_lens, out, ws_ml,
                                ws_acc, R, W, NH, NKV, NP, P, MAXP, nsplit, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
