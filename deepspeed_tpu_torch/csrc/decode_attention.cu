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
// kv_len == 0 are written as exact zeros. K6 clamps kv_len into [0, S]; K5
// clamps page ids into [0, NP), so a -1 sentinel reads page 0, which the
// length then masks, and kv_len into [0, MAXP * P].
//
// What bounds it: memory. Each key row read (2 * D * dtype bytes of K and V)
// feeds 4 * D flops per query head, 4 * Hg * D per group: at Hg = 8 and bf16
// that is 8 flops per byte, far below the card's ~295 flops/byte balance
// point. The least time is the bytes of q, the output and the LIVE K/V rows
// (whole live pages for K5) over HBM bandwidth.
//
// Both are flash-decoding: a split kernel over decode_split_block, then
// decode_combine_kernel. The split body is written over a Rows addressing
// functor, so the two differ only in how a key row is found: DenseRows for
// K6 (dense_decode_split_kernel), PagedRows through the page table for K5
// (paged_decode_split_kernel).
//  * the grid is (split, kv head, row): each row's keys are cut into splits
//    of SPLIT = 64 keys, and the number of splits, ceil(S / SPLIT) for K6 and
//    ceil(MAXP * P / SPLIT) for K5, comes from the shapes alone (no kv_lens on
//    the host: no sync, and the calls stay capturable in a CUDA graph). At the
//    generate shape of llama-1B (B = 16, S = 256, NKV = 4) K6 runs 4 x 4 x 16
//    = 256 blocks on 132 SMs; at bucket 8 (MAXP * P = 2048) K5 runs 1024;
//  * a block stages its split's K and V once by 16-byte cp.async into
//    swizzled tiles, finding each key row on its own (so a K5 split may span
//    pages or cover part of one; keys at or past kv_len are zero-filled and
//    never fetched, and kv_len is clamped to the cache, so no key past S or
//    MAXP * P is read), and serves every query head of its GQA group from
//    that copy, QH heads at a time; a split at or past kv_len does nothing;
//  * fp32 FMAs for every dtype (the call is bound by bytes: 8 x 64 scores a
//    block): a thread per (key, half of the heads) for the scores, a warp per
//    head for the split's softmax, and in P.V a thread per output column of
//    several heads, reading each V value once for all of them. A group
//    smaller than QH leaves the other head slots' score and softmax work
//    undone, and at MHA (one head) their P.V work too;
//  * each block writes per head a partial (m, l, acc); the combine merges a
//    row's splits below kv_len in split order (M = max m, L = sum
//    exp(m - M) l, O = sum exp(m - M) acc / L): no atomics, so two calls give
//    bitwise-equal results, and it writes the exact zeros of dead rows. The
//    fp32 workspace is sized from the shapes by the wrapper (torch.empty).
// Not done yet (later work): tensor cores for the scores (S^T = K Q^T fits
// m16n8k16 with keys as M and the 8 heads as N).

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

// ---------------------------------------------------------------------------------------------
// K5 and K6: split-KV over the keys, then an in-order combine
// ---------------------------------------------------------------------------------------------
constexpr int SPLIT = 64;  // keys of a split (one staged tile)

// element offset of (row, col) in a tile of rows of D values of T whose 16-byte chunks are
// swizzled by the row (chunk c of row r at c ^ (r & 7)); col is a multiple of 16 / sizeof(T)
template <typename T, int D>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int E = 16 / sizeof(T);
  return row * D + (((col / E) ^ (row & 7)) * E);
}

// o[a] = sum_j ps[row0 + a * RSTEP][j] * V[j][d] over the nk keys of the split, for the NA rows
// a < NA (a count fixed at compile time, so o stays in registers); each V value is read once for
// all of them, four keys' probabilities a float4.
template <int NA, int RSTEP, int SP, typename T, int D>
__device__ __forceinline__ void pv_rows(const float* __restrict__ ps, const T* __restrict__ vs, int row0, int d,
                                        int nk, float* o) {
  constexpr int E = 16 / sizeof(T);
  for (int j = 0; j < nk; j += 4) {
    float vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) vv[u] = to_f32(vs[swz<T, D>(j + u, d - d % E) + d % E]);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const float4 p = *reinterpret_cast<const float4*>(ps + (row0 + a * RSTEP) * SP + j);
      o[a] = fmaf(p.x, vv[0], o[a]);
      o[a] = fmaf(p.y, vv[1], o[a]);
      o[a] = fmaf(p.z, vv[2], o[a]);
      o[a] = fmaf(p.w, vv[3], o[a]);
    }
  }
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

    // scores: thread = (key j, heads hb .. hb + HPT - 1); masked keys hold NEG_INF. Threads whose
    // heads all lie past the group (nh <= hb: at MHA the half with hb = HPT) skip them; no later
    // step reads those rows into an output.
    const int hb = (tid / SPLIT) * HPT;
    if (hb < nh) {
      const int j = tid % SPLIT;
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
    // softmax over the split, a warp per live head; masked keys give p = 0
    for (int i = warp; i < nh; i += THREADS / 32) {
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
    // acc = P V: a thread owns column d of rows row0 + a * RSTEP, its na rows below nh live (row0
    // is warp-uniform, D >= 32). A full group runs all ACC rows; at MHA (na = 1 for row0 = 0, 0
    // past it) only the live row runs. A partial group between them (2 <= nh < QH) computes the
    // ACC rows and keeps its na: one code path for such groups, not one a count.
    {
      const int d = tid % D, row0 = tid / D;
      const int na = row0 < nh ? min(ACC, (nh - row0 + RSTEP - 1) / RSTEP) : 0;
      float o[ACC];
#pragma unroll
      for (int a = 0; a < ACC; ++a) o[a] = 0.f;
      if (na == 1)
        pv_rows<1, RSTEP, SP, T, D>(ps, vs, row0, d, nk, o);
      else if (na > 0)
        pv_rows<ACC, RSTEP, SP, T, D>(ps, vs, row0, d, nk, o);
      // partials [B][NKV][nsplit][Hg] (m, l) and [..][D] acc
      const size_t base = (((size_t)r * NKV + g) * nsplit + blockIdx.x) * Hg + h0;
#pragma unroll
      for (int a = 0; a < ACC; ++a) {
        if (a < na) ws_acc[(base + row0 + a * RSTEP) * D + d] = o[a];
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
dense_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k_cache, const T* __restrict__ v_cache,
                          const int* __restrict__ kv_lens, float2* __restrict__ ws_ml, float* __restrict__ ws_acc,
                          int NH, int NKV, int S, int nsplit, float scale) {
  const int kv_len = min(max(kv_lens[blockIdx.z], 0), S);
  decode_split_block<T, D>(q, k_cache, v_cache, kv_len, ws_ml, ws_acc, NH, NKV, nsplit, scale,
                           DenseRows{S, NKV});
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

template <typename T, int D>
size_t split_smem() {  // K and V, q, scores, m and l
  return sizeof(T) * 2 * SPLIT * D + sizeof(float) * (QH * D + QH * (SPLIT + 4) + 2 * QH);
}

// The split kernel `split` over a (nsplit, NKV, B) grid with `args`, then the combine over the keys
// below each row's kv_len clamped to max_len; returns the first non-zero cudaError_t of the two.
template <typename T, int D, typename... Params, typename... Args>
int split_then_combine(void (*split)(Params...), const void* kv_lens, void* out, void* ws_ml, void* ws_acc, int B,
                       int NH, int NKV, int nsplit, int max_len, cudaStream_t stream, Args... args) {
  const size_t smem = split_smem<T, D>();
  cudaError_t err = cudaFuncSetAttribute(split, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  split<<<dim3(nsplit, NKV, B), THREADS, smem, stream>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(B) * NH;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  decode_combine_kernel<T, D><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const float2*>(ws_ml), static_cast<const float*>(ws_acc), static_cast<const int*>(kv_lens),
      static_cast<T*>(out), B, NH, NKV, nsplit, max_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dense_launch_d(const void* q, const void* k, const void* v, const void* kv_lens, void* out, void* ws_ml,
                   void* ws_acc, int B, int NH, int NKV, int S, int nsplit, float scale, cudaStream_t stream) {
  return split_then_combine<T, D>(
      dense_decode_split_kernel<T, D>, kv_lens, out, ws_ml, ws_acc, B, NH, NKV, nsplit, S, stream,
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const int*>(kv_lens),
      static_cast<float2*>(ws_ml), static_cast<float*>(ws_acc), NH, NKV, S, nsplit, scale);
}

template <typename T>
int dense_launch(int D, const void* q, const void* k, const void* v, const void* kv_lens, void* out, void* ws_ml,
                 void* ws_acc, int B, int NH, int NKV, int S, int nsplit, float scale, cudaStream_t stream) {
  if (D == 64)
    return dense_launch_d<T, 64>(q, k, v, kv_lens, out, ws_ml, ws_acc, B, NH, NKV, S, nsplit, scale, stream);
  if (D == 128)
    return dense_launch_d<T, 128>(q, k, v, kv_lens, out, ws_ml, ws_acc, B, NH, NKV, S, nsplit, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
int paged_launch_d(const void* q, const void* k, const void* v, const void* page_table, const void* kv_lens,
                   void* out, void* ws_ml, void* ws_acc, int B, int NH, int NKV, int NP, int P, int MAXP,
                   int nsplit, float scale, cudaStream_t stream) {
  return split_then_combine<T, D>(
      paged_decode_split_kernel<T, D>, kv_lens, out, ws_ml, ws_acc, B, NH, NKV, nsplit, MAXP * P, stream,
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_lens), static_cast<float2*>(ws_ml),
      static_cast<float*>(ws_acc), NH, NKV, NP, P, MAXP, nsplit, scale);
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

// dtype: 0 float32, 1 bfloat16, 2 float16. Neither entry synchronises.

// Keys a split holds (K5 and K6): the wrapper sizes the workspace from it, nsplit = ceil(S / split)
// for K6 and ceil(MAXP * P / split) for K5.
extern "C" int decode_split_keys() { return SPLIT; }

// K6: q [B, NH, D], k_cache / v_cache [B, S, NKV, D], kv_lens [B] int32,
// out [B, NH, D]; ws_ml holds B * NH * nsplit float2 and ws_acc D times as
// many floats, nsplit = ceil(S / split_keys); their contents on entry do not
// matter. Runs the split kernel and the combine; returns the first non-zero
// cudaError_t of the two.
extern "C" int dense_decode_attention(int dtype, const void* q, const void* k_cache, const void* v_cache,
                                      const void* kv_lens, void* out, void* ws_ml, void* ws_acc, int B, int NH,
                                      int NKV, int S, int D, int nsplit, float scale, void* stream) {
  if (bad_heads(B, NH, NKV, D) || S <= 0 || nsplit <= 0 || nsplit > 65535 ||
      static_cast<long long>(nsplit) * SPLIT < S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dense_launch<float>(D, q, k_cache, v_cache, kv_lens, out, ws_ml, ws_acc, B, NH, NKV, S, nsplit,
                                 scale, s);
    case 1:
      return dense_launch<__nv_bfloat16>(D, q, k_cache, v_cache, kv_lens, out, ws_ml, ws_acc, B, NH, NKV, S,
                                         nsplit, scale, s);
    case 2:
      return dense_launch<__half>(D, q, k_cache, v_cache, kv_lens, out, ws_ml, ws_acc, B, NH, NKV, S, nsplit,
                                  scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
