// Single-token decode attention for Hopper (sm_90a), plain C interface for
// ctypes: one kernel per cache layout.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/transformer/decode_attention.py:
//  * K6 _decode_kernel (pallas_call in _grouped_decode, entry decode_attention):
//    dense_decode_attention below, over a contiguous cache [B, S, NKV, D];
//  * K5 _paged_kernel (pallas_call in paged_decode_attention):
//    paged_decode_attention below, over a shared page pool [NP, NKV, P, D]
//    read through a page table [B, MAXP].
// Both compute the same function: row b's one query token (NH heads, q
// [B, NH, D]) attends to the keys kv_pos < kv_len[b]; query head h reads kv
// head h / (NH / NKV). q, k and v are read in their dtype and converted to
// fp32; scores, the softmax (finite NEG_INF = -1e30 masking) and P.V run in
// fp32 with the scale; the output is written in q's dtype. Rows with
// kv_len == 0 are written as exact zeros. K5 clamps page ids into [0, NP),
// so a -1 sentinel reads page 0, which the length then masks, and kv_len
// into [0, MAXP * P].
//
// What bounds it: memory. Each key row read (2 * D * dtype bytes of K and V)
// feeds 4 * D flops per query head, 4 * Hg * D per group: at Hg = 8 and bf16
// that is 8 flops per byte, far below the card's ~295 flops/byte balance
// point. The least time is the bytes of q, the output and the LIVE K/V rows
// (whole live pages for K5) over HBM bandwidth.
//
// K6 (dense_decode_kernel over decode_block): one block per (row, kv head,
// tile of up to QH = 8 query heads of that kv head's group), so each K/V row
// is read from HBM once per group (Hg <= 8); the block walks only the live
// keys, staging K/V a tile of KT = 4096 / D keys at a time with 16-byte
// vector loads, with the online-softmax state in shared memory and registers
// (the TPU kernel carried it across a sequential grid axis over cache blocks).
//
// K5 (paged_decode_split_kernel over decode_split_block, then
// decode_combine_kernel): flash-decoding, K4's layout at one query token.
//  * the grid is (split, kv head, row): each row's keys are cut into splits
//    of SPLIT = 64 keys, and the number of splits, ceil(MAXP * P / SPLIT),
//    comes from the shapes alone (no kv_lens on the host: no sync, and the
//    bucketed round stays capturable in a CUDA graph). At bucket 8 of
//    llama-1B (MAXP * P = 2048, NKV = 4) that is 32 x 4 x 8 = 1024 blocks on
//    132 SMs instead of 32 blocks walking up to 2048 keys each;
//  * a block stages its split's K and V once by 16-byte cp.async into
//    swizzled tiles, looking up each key row's page (so a split may span
//    pages or cover part of one; keys at or past kv_len are zero-filled and
//    never fetched), and serves every query head of its GQA group from that
//    copy, QH heads at a time; a split at or past kv_len does nothing;
//  * fp32 FMAs for every dtype (the call is bound by bytes: 8 x 64 scores a
//    block): a thread per (key, half of the heads) for the scores, a warp per
//    head for the split's softmax, and in P.V a thread per output column of
//    several heads, reading each V value once for all of them;
//  * each block writes per head a partial (m, l, acc); the combine merges a
//    row's splits below kv_len in split order (M = max m, L = sum
//    exp(m - M) l, O = sum exp(m - M) acc / L): no atomics, so two calls give
//    bitwise-equal results, and it writes the exact zeros of dead rows. The
//    fp32 workspace is sized from the shapes by the wrapper (torch.empty).
// The split body is written over the Rows addressing functor, so K6
// (DenseRows) can take it too; K6 keeps decode_block for now.
// Not done yet (later work): tensor cores for K5's scores (S^T = K Q^T fits
// m16n8k16 with keys as M and the 8 heads as N), and K6 on the split body.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int QH = 8;         // query heads per block
constexpr int THREADS = 128;  // four warps

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

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

// Element offset of key position `pos` of kv head g in row r of a
// contiguous cache [B, S, NKV, D].
struct DenseRows {
  int S, NKV;
  __device__ __forceinline__ size_t operator()(int r, int g, int pos, int D) const {
    return (((size_t)r * S + pos) * NKV + g) * D;
  }
};

// The same through row r's page table into a pool [NP, NKV, P, D]; ids are
// clamped into [0, NP) (slots past MAXP read page 0).
struct PagedRows {
  const int* __restrict__ page_table;
  int NP, NKV, P, MAXP;
  __device__ __forceinline__ size_t operator()(int r, int g, int pos, int D) const {
    const int slot = pos / P;
    int pid = slot < MAXP ? page_table[(size_t)r * MAXP + slot] : 0;
    pid = min(max(pid, 0), NP - 1);
    return (((size_t)pid * NKV + g) * P + pos % P) * D;
  }
};

// One block: row r = blockIdx.z, kv head g = blockIdx.y, query heads
// h0 .. h0 + nq - 1 of that kv head's group (h0 = blockIdx.x * QH), over the
// keys 0 .. kv_len - 1.
template <typename T, int D, typename Rows>
__device__ __forceinline__ void decode_block(const T* __restrict__ q, const T* __restrict__ k,
                                             const T* __restrict__ v, int kv_len, T* __restrict__ out,
                                             int NH, int NKV, float scale, const Rows& rows) {
  constexpr int KT = 4096 / D;            // keys per staged kv tile
  constexpr int ACC = QH * D / THREADS;   // output elements per thread
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  __shared__ float qs[QH][D];
  __shared__ float ks[KT][D + 1];         // +1: conflict-free column reads
  __shared__ float vs[KT][D];
  __shared__ float ps[QH][KT + 1];        // scores, then probabilities
  __shared__ float m_s[QH], l_s[QH], corr_s[QH];

  const int r = blockIdx.z;
  const int g = blockIdx.y;
  const int Hg = NH / NKV;
  const int h0 = blockIdx.x * QH;
  const int nq = min(QH, Hg - h0);
  const int tid = threadIdx.x;
  const size_t qbase = ((size_t)r * NH + g * Hg + h0) * D;

  if (tid < QH) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;

  if (kv_len > 0) {  // block-uniform
    for (int e = tid; e < QH * D; e += THREADS) {
      const int i = e / D, d = e % D;
      qs[i][d] = i < nq ? to_f32(q[qbase + (size_t)i * D + d]) : 0.f;
    }
    const int warp = tid / 32, lane = tid % 32;
    for (int base = 0; base < kv_len; base += KT) {
      const int nkeys = min(KT, kv_len - base);
      __syncthreads();  // the previous tile is consumed; q and m/l are written
      for (int c = tid; c < nkeys * D / VEC; c += THREADS) {
        const int e = c * VEC;
        const int row = e / D, col = e % D;
        const size_t off = rows(r, g, base + row, D) + col;
        const uint4 kr = __ldg(reinterpret_cast<const uint4*>(k + off));
        const uint4 vr = __ldg(reinterpret_cast<const uint4*>(v + off));
        const T* kv = reinterpret_cast<const T*>(&kr);
        const T* vv = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int t = 0; t < VEC; ++t) {
          ks[row][col + t] = to_f32(kv[t]);
          vs[row][col + t] = to_f32(vv[t]);
        }
      }
      __syncthreads();
      // scores: entries past the tile's keys or the block's heads hold NEG_INF
      for (int e = tid; e < QH * KT; e += THREADS) {
        const int i = e / KT, j = e % KT;
        float s = NEG_INF;
        if (i < nq && j < nkeys) {
          float dot = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += qs[i][d] * ks[j][d];
          s = dot * scale;
        }
        ps[i][j] = s;
      }
      __syncthreads();
      // online softmax, one warp per query head; a masked entry contributes
      // p = 0 even while the running max is still NEG_INF
      for (int i = warp; i < QH; i += THREADS / 32) {
        float mx = NEG_INF;
        for (int j = lane; j < KT; j += 32) mx = fmaxf(mx, ps[i][j]);
        mx = warp_max(mx);
        const float m_prev = m_s[i];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int j = lane; j < KT; j += 32) {
          const float p = (i < nq && j < nkeys) ? expf(ps[i][j] - m_new) : 0.f;
          ps[i][j] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          corr_s[i] = corr;
          l_s[i] = l_s[i] * corr + sum;
          m_s[i] = m_new;
        }
      }
      __syncthreads();
      // acc = acc * corr + P.V over the tile's keys
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int e = tid + a * THREADS;
        const int i = e / D, d = e % D;
        float val = acc[a] * corr_s[i];
        for (int j = 0; j < nkeys; ++j) val += ps[i][j] * vs[j][d];
        acc[a] = val;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int e = tid + a * THREADS;
    const int i = e / D, d = e % D;
    if (i < nq) {
      const float l = l_s[i];
      out[qbase + (size_t)i * D + d] = from_f32<T>(acc[a] / (l == 0.f ? 1.f : l));
    }
  }
}

// K6: the contiguous cache.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                    const T* __restrict__ v_cache, const int* __restrict__ kv_lens,
                    T* __restrict__ out, int NH, int NKV, int S, float scale) {
  const int kv_len = min(max(kv_lens[blockIdx.z], 0), S);
  decode_block<T, D>(q, k_cache, v_cache, kv_len, out, NH, NKV, scale, DenseRows{S, NKV});
}

// ---------------------------------------------------------------------------------------------
// K5: split-KV over the page pool, then an in-order combine
// ---------------------------------------------------------------------------------------------
constexpr int SPLIT = 64;  // keys of a split (one staged tile)

// element offset of (row, col) in a tile of rows of D values of T whose 16-byte chunks are
// swizzled by the row (chunk c of row r at c ^ (r & 7)); col is a multiple of 16 / sizeof(T)
template <typename T, int D>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int E = 16 / sizeof(T);
  return row * D + (((col / E) ^ (row & 7)) * E);
}

// One block: row r = blockIdx.z, kv head g = blockIdx.y, keys s0 .. s0 + SPLIT - 1 (s0 =
// blockIdx.x * SPLIT) of that row, read through `rows`. The split's K and V are staged once by
// cp.async (each key row's offset looked up on its own, so a split may span pages or cover part
// of one; keys at or past kv_len are zero-filled) and serve every query head of the group, QH at
// a time. For each head it writes the partial (m, l, acc): m the largest scaled score among the
// split's live keys, l = sum exp(s - m), acc = sum exp(s - m) v. A split at or past kv_len writes
// nothing (the combine reads only the splits below kv_len, each of which holds a live key).
template <typename T, int D, typename Rows>
__device__ __forceinline__ void decode_split_block(const T* __restrict__ q, const T* __restrict__ k,
                                                   const T* __restrict__ v, int kv_len, float2* __restrict__ ws_ml,
                                                   float* __restrict__ ws_acc, int NH, int NKV, int nsplit,
                                                   float scale, const Rows& rows) {
  constexpr int E = 16 / sizeof(T);       // elements a 16-byte copy
  constexpr int CH = D / E;               // 16-byte chunks a row
  constexpr int SP = SPLIT + 4;           // score row, padded; float4-aligned
  constexpr int HPT = QH * SPLIT / THREADS;  // heads a thread scores (one key each)
  constexpr int ACC = QH * D / THREADS;   // output elements a thread
  constexpr int RSTEP = THREADS / D;      // rows between a thread's outputs (D <= THREADS)
  static_assert(THREADS % SPLIT == 0 && HPT * (THREADS / SPLIT) == QH, "thread map");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);           // [SPLIT][D] swizzled
  T* vs = ks + SPLIT * D;                           // [SPLIT][D] swizzled
  float* qs = reinterpret_cast<float*>(vs + SPLIT * D);  // [QH][D]
  float* ps = qs + QH * D;                          // [QH][SP] scores, then probabilities
  float* m_s = ps + QH * SP;                        // [QH]
  float* l_s = m_s + QH;                            // [QH]

  const int r = blockIdx.z, g = blockIdx.y;
  const int s0 = blockIdx.x * SPLIT;
  if (s0 >= kv_len) return;  // block-uniform
  const int nk = min(SPLIT, kv_len - s0);
  const int Hg = NH / NKV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < SPLIT * CH; e += THREADS) {
    const int row = e / CH, c = e % CH;
    const bool valid = row < nk;
    const size_t off = valid ? rows(r, g, s0 + row, D) + c * E : 0;
    tc::cp_async16(ks + swz<T, D>(row, c * E), k + off, valid);
    tc::cp_async16(vs + swz<T, D>(row, c * E), v + off, valid);
  }
  tc::cp_async_commit();

  for (int h0 = 0; h0 < Hg; h0 += QH) {
    const int nh = min(QH, Hg - h0);
    const size_t qbase = ((size_t)r * NH + g * Hg + h0) * D;
    if (h0 > 0) __syncthreads();  // every thread is done with the previous heads' q and ps
    for (int e = tid; e < QH * D; e += THREADS) {
      const int i = e / D, d = e % D;
      qs[e] = i < nh ? to_f32(q[qbase + (size_t)i * D + d]) : 0.f;
    }
    if (h0 == 0) tc::cp_async_wait<0>();
    __syncthreads();

    // scores: thread = (key j, heads hb .. hb + HPT - 1); masked keys hold NEG_INF
    {
      const int j = tid % SPLIT, hb = (tid / SPLIT) * HPT;
      float sc[HPT];
#pragma unroll
      for (int i = 0; i < HPT; ++i) sc[i] = 0.f;
#pragma unroll 2
      for (int c = 0; c < CH; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ks + swz<T, D>(j, c * E));
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int t = 0; t < E; t += 4) {
          const float k0 = to_f32(kv[t]), k1 = to_f32(kv[t + 1]), k2 = to_f32(kv[t + 2]), k3 = to_f32(kv[t + 3]);
#pragma unroll
          for (int i = 0; i < HPT; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + (hb + i) * D + c * E + t);
            sc[i] = fmaf(qv.x, k0, sc[i]);
            sc[i] = fmaf(qv.y, k1, sc[i]);
            sc[i] = fmaf(qv.z, k2, sc[i]);
            sc[i] = fmaf(qv.w, k3, sc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < HPT; ++i) ps[(hb + i) * SP + j] = j < nk ? sc[i] * scale : NEG_INF;
    }
    __syncthreads();
    // softmax over the split, a warp per head; masked keys give p = 0
    for (int i = warp; i < QH; i += THREADS / 32) {
      float mx = NEG_INF;
      for (int j = lane; j < SPLIT; j += 32) mx = fmaxf(mx, ps[i * SP + j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < SPLIT; j += 32) {
        const float p = j < nk ? expf(ps[i * SP + j] - mx) : 0.f;
        ps[i * SP + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[i] = mx;
        l_s[i] = sum;
      }
    }
    __syncthreads();
    // acc = P V: a thread owns column d of rows row0 + a * RSTEP, so each V value is read once for
    // all of them; four keys' probabilities a float4
    {
      const int d = tid % D, row0 = tid / D;
      float o[ACC];
#pragma unroll
      for (int a = 0; a < ACC; ++a) o[a] = 0.f;
      for (int j = 0; j < nk; j += 4) {
        float vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[u] = to_f32(vs[swz<T, D>(j + u, d - d % E) + d % E]);
#pragma unroll
        for (int a = 0; a < ACC; ++a) {
          const float4 p = *reinterpret_cast<const float4*>(ps + (row0 + a * RSTEP) * SP + j);
          o[a] = fmaf(p.x, vv[0], o[a]);
          o[a] = fmaf(p.y, vv[1], o[a]);
          o[a] = fmaf(p.z, vv[2], o[a]);
          o[a] = fmaf(p.w, vv[3], o[a]);
        }
      }
      // partials [B][NKV][nsplit][Hg] (m, l) and [..][D] acc
      const size_t base = (((size_t)r * NKV + g) * nsplit + blockIdx.x) * Hg + h0;
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        const int i = row0 + a * RSTEP;
        if (i < nh) ws_acc[(base + i) * D + d] = o[a];
      }
      if (tid < nh) ws_ml[base + tid] = make_float2(m_s[tid], l_s[tid]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                          const T* __restrict__ v_pages, const int* __restrict__ page_table,
                          const int* __restrict__ kv_lens, float2* __restrict__ ws_ml, float* __restrict__ ws_acc,
                          int NH, int NKV, int NP, int P, int MAXP, int nsplit, float scale) {
  const int kv_len = min(max(kv_lens[blockIdx.z], 0), MAXP * P);
  decode_split_block<T, D>(q, k_pages, v_pages, kv_len, ws_ml, ws_acc, NH, NKV, nsplit, scale,
                           PagedRows{page_table, NP, NKV, P, MAXP});
}

// The combine: one warp per output row (b, h), the partials of the splits below kv_len merged in
// split order: M = max m, L = sum exp(m - M) l, O = sum exp(m - M) acc / L. No atomics, so two
// calls give bitwise-equal results. Rows with kv_len == 0 are written as exact zeros.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float2* __restrict__ ws_ml, const float* __restrict__ ws_acc,
                      const int* __restrict__ kv_lens, T* __restrict__ out, int B, int NH, int NKV,
                      int nsplit, int max_len) {
  constexpr int V = D / 32;  // output values a lane
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32) + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(B) * NH) return;
  const int lane = threadIdx.x & 31;
  const int h = static_cast<int>(row % NH), b = static_cast<int>(row / NH);
  const int kv_len = min(max(kv_lens[b], 0), max_len);
  const int live = (kv_len + SPLIT - 1) / SPLIT;  // splits holding a live key
  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = 0.f;
  if (live > 0) {
    const int Hg = NH / NKV, g = h / Hg;
    const size_t first = ((size_t)b * NKV + g) * nsplit * Hg + h % Hg;  // split s at first + s * Hg
    float M = NEG_INF;
    for (int s = 0; s < live; ++s) M = fmaxf(M, ws_ml[first + (size_t)s * Hg].x);
    float L = 0.f;
    for (int s = 0; s < live; ++s) {
      const size_t at = first + (size_t)s * Hg;
      const float2 p = ws_ml[at];
      const float wgt = expf(p.x - M);
      L += wgt * p.y;
      const float* a = ws_acc + at * D + lane * V;
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] += wgt * a[i];
    }
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] /= L;
  }
  T* dst = out + row * D + lane * V;
#pragma unroll
  for (int i = 0; i < V; ++i) dst[i] = from_f32<T>(o[i]);
}

dim3 grid_of(int B, int NH, int NKV) {
  const int Hg = NH / NKV;
  return dim3((Hg + QH - 1) / QH, NKV, B);
}

template <typename T>
int dense_launch(int D, const void* q, const void* k, const void* v, const void* kv_lens, void* out,
                 int B, int NH, int NKV, int S, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lens = static_cast<const int*>(kv_lens);
  T* o = static_cast<T*>(out);
  if (D == 64)
    dense_decode_kernel<T, 64><<<grid_of(B, NH, NKV), THREADS, 0, stream>>>(qt, kt, vt, lens, o, NH, NKV, S, scale);
  else if (D == 128)
    dense_decode_kernel<T, 128><<<grid_of(B, NH, NKV), THREADS, 0, stream>>>(qt, kt, vt, lens, o, NH, NKV, S, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
size_t split_smem() {  // K and V, q, scores, m and l
  return sizeof(T) * 2 * SPLIT * D + sizeof(float) * (QH * D + QH * (SPLIT + 4) + 2 * QH);
}

template <typename T, int D>
int paged_launch_d(const void* q, const void* k, const void* v, const void* page_table, const void* kv_lens,
                   void* out, void* ws_ml, void* ws_acc, int B, int NH, int NKV, int NP, int P, int MAXP,
                   int nsplit, float scale, cudaStream_t stream) {
  const size_t smem = split_smem<T, D>();
  auto split = paged_decode_split_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  split<<<dim3(nsplit, NKV, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens), static_cast<float2*>(ws_ml),
      static_cast<float*>(ws_acc), NH, NKV, NP, P, MAXP, nsplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * NH;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  decode_combine_kernel<T, D><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const float2*>(ws_ml), static_cast<const float*>(ws_acc), static_cast<const int*>(kv_lens),
      static_cast<T*>(out), B, NH, NKV, nsplit, MAXP * P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int paged_launch(int D, const void* q, const void* k, const void* v, const void* page_table,
                 const void* kv_lens, void* out, void* ws_ml, void* ws_acc, int B, int NH, int NKV, int NP,
                 int P, int MAXP, int nsplit, float scale, cudaStream_t stream) {
  if (D == 64)
    return paged_launch_d<T, 64>(q, k, v, page_table, kv_lens, out, ws_ml, ws_acc, B, NH, NKV, NP, P, MAXP,
                                 nsplit, scale, stream);
  if (D == 128)
    return paged_launch_d<T, 128>(q, k, v, page_table, kv_lens, out, ws_ml, ws_acc, B, NH, NKV, NP, P, MAXP,
                                  nsplit, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_heads(int B, int NH, int NKV, int D) {
  return B <= 0 || NKV <= 0 || NH <= 0 || NH % NKV != 0 || (D != 64 && D != 128) || B > 65535 ||
         NKV > 65535;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16. Each returns the launch's
// cudaError_t (0 = launched); neither synchronises.

// K6: q [B, NH, D], k_cache / v_cache [B, S, NKV, D], kv_lens [B] int32,
// out [B, NH, D].
extern "C" int dense_decode_attention(int dtype, const void* q, const void* k_cache,
                                      const void* v_cache, const void* kv_lens, void* out, int B,
                                      int NH, int NKV, int S, int D, float scale, void* stream) {
  if (bad_heads(B, NH, NKV, D) || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dense_launch<float>(D, q, k_cache, v_cache, kv_lens, out, B, NH, NKV, S, scale, s);
    case 1:
      return dense_launch<__nv_bfloat16>(D, q, k_cache, v_cache, kv_lens, out, B, NH, NKV, S, scale, s);
    case 2:
      return dense_launch<__half>(D, q, k_cache, v_cache, kv_lens, out, B, NH, NKV, S, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Keys a K5 split holds: the wrapper sizes the workspace from it, nsplit = ceil(MAXP * P / split).
extern "C" int paged_decode_split_keys() { return SPLIT; }

// K5: q [B, NH, D], k_pages / v_pages [NP, NKV, P, D], page_table [B, MAXP]
// int32, kv_lens [B] int32, out [B, NH, D]; ws_ml holds B * NH * nsplit
// float2 and ws_acc D times as many floats, nsplit = ceil(MAXP * P /
// split_keys); their contents on entry do not matter. Runs the split kernel
// and the combine; returns the first non-zero cudaError_t of the two.
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k_pages,
                                      const void* v_pages, const void* page_table,
                                      const void* kv_lens, void* out, void* ws_ml, void* ws_acc, int B,
                                      int NH, int NKV, int NP, int P, int D, int MAXP, int nsplit,
                                      float scale, void* stream) {
  if (bad_heads(B, NH, NKV, D) || NP <= 0 || P <= 0 || MAXP <= 0 || nsplit <= 0 || nsplit > 65535 ||
      static_cast<long long>(nsplit) * SPLIT < static_cast<long long>(MAXP) * P)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return paged_launch<float>(D, q, k_pages, v_pages, page_table, kv_lens, out, ws_ml, ws_acc, B, NH, NKV,
                                 NP, P, MAXP, nsplit, scale, s);
    case 1:
      return paged_launch<__nv_bfloat16>(D, q, k_pages, v_pages, page_table, kv_lens, out, ws_ml, ws_acc, B,
                                         NH, NKV, NP, P, MAXP, nsplit, scale, s);
    case 2:
      return paged_launch<__half>(D, q, k_pages, v_pages, page_table, kv_lens, out, ws_ml, ws_acc, B, NH,
                                  NKV, NP, P, MAXP, nsplit, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
