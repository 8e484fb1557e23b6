// Vectorized host Adam / AdamW for offloaded optimizer state (ZeRO-Offload,
// ZeRO-Infinity).
//
// The port's copy of the JAX package's csrc/adam/cpu_adam.cpp, code
// unchanged: the fp32 master partition and moments live in host DRAM, the
// card computes the gradients, and this library applies the fused Adam
// update on the host's vector units. ops/native.py builds it with the JAX
// build's flags, so the two packages' host Adam agree bit for bit.
//
// SIMD: AVX-512/AVX2 intrinsics when compiled in (-march=native), scalar
// fallback otherwise. Large tensors are sliced across at most 8 threads.

#include <cmath>
#include <cstdint>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

struct AdamState {
    float lr;
    float beta1;
    float beta2;
    float eps;
    float weight_decay;
    bool adamw_mode;
};

std::unordered_map<int, AdamState> g_optimizers;
std::mutex g_mu;

// Scalar reference path; also the tail handler for the SIMD paths.
void adam_scalar(float* p, const float* g, float* m, float* v, int64_t lo, int64_t hi,
                 float lr, float beta1, float beta2, float eps, float weight_decay,
                 float bc1, float bc2, bool adamw) {
    const float step_size = lr / bc1;
    for (int64_t i = lo; i < hi; ++i) {
        float grad = g[i];
        if (!adamw && weight_decay > 0.f) grad += weight_decay * p[i];
        m[i] = beta1 * m[i] + (1.f - beta1) * grad;
        v[i] = beta2 * v[i] + (1.f - beta2) * grad * grad;
        float denom = std::sqrt(v[i]) / std::sqrt(bc2) + eps;
        // torch-AdamW convention: decoupled decay is lr*wd*p, NOT scaled by
        // the bias correction (matches ops/adam/fused_adam.py:77-81)
        if (adamw && weight_decay > 0.f) p[i] -= lr * weight_decay * p[i];
        p[i] -= step_size * (m[i] / denom);
    }
}

#if defined(__AVX512F__)
constexpr int64_t kWidth = 16;
void adam_simd(float* p, const float* g, float* m, float* v, int64_t lo, int64_t hi,
               float lr, float beta1, float beta2, float eps, float weight_decay,
               float bc1, float bc2, bool adamw) {
    const __m512 vb1 = _mm512_set1_ps(beta1);
    const __m512 vb2 = _mm512_set1_ps(beta2);
    const __m512 vomb1 = _mm512_set1_ps(1.f - beta1);
    const __m512 vomb2 = _mm512_set1_ps(1.f - beta2);
    const __m512 veps = _mm512_set1_ps(eps);
    const __m512 vwd = _mm512_set1_ps(weight_decay);
    const __m512 vstep = _mm512_set1_ps(-lr / bc1);
    const __m512 vlrwd = _mm512_set1_ps(lr * weight_decay);
    const __m512 vrsqrt_bc2 = _mm512_set1_ps(1.f / std::sqrt(bc2));
    int64_t i = lo;
    for (; i + kWidth <= hi; i += kWidth) {
        __m512 vp = _mm512_loadu_ps(p + i);
        __m512 vg = _mm512_loadu_ps(g + i);
        if (!adamw && weight_decay > 0.f) vg = _mm512_fmadd_ps(vwd, vp, vg);
        __m512 vm = _mm512_fmadd_ps(vb1, _mm512_loadu_ps(m + i), _mm512_mul_ps(vomb1, vg));
        __m512 vv = _mm512_fmadd_ps(vb2, _mm512_loadu_ps(v + i),
                                    _mm512_mul_ps(vomb2, _mm512_mul_ps(vg, vg)));
        _mm512_storeu_ps(m + i, vm);
        _mm512_storeu_ps(v + i, vv);
        __m512 denom = _mm512_add_ps(_mm512_mul_ps(_mm512_sqrt_ps(vv), vrsqrt_bc2), veps);
        __m512 upd = _mm512_div_ps(vm, denom);
        if (adamw && weight_decay > 0.f) vp = _mm512_fnmadd_ps(vlrwd, vp, vp);
        _mm512_storeu_ps(p + i, _mm512_fmadd_ps(vstep, upd, vp));
    }
    adam_scalar(p, g, m, v, i, hi, lr, beta1, beta2, eps, weight_decay, bc1, bc2, adamw);
}
#elif defined(__AVX2__)
constexpr int64_t kWidth = 8;
void adam_simd(float* p, const float* g, float* m, float* v, int64_t lo, int64_t hi,
               float lr, float beta1, float beta2, float eps, float weight_decay,
               float bc1, float bc2, bool adamw) {
    const __m256 vb1 = _mm256_set1_ps(beta1);
    const __m256 vb2 = _mm256_set1_ps(beta2);
    const __m256 vomb1 = _mm256_set1_ps(1.f - beta1);
    const __m256 vomb2 = _mm256_set1_ps(1.f - beta2);
    const __m256 veps = _mm256_set1_ps(eps);
    const __m256 vwd = _mm256_set1_ps(weight_decay);
    const __m256 vstep = _mm256_set1_ps(-lr / bc1);
    const __m256 vlrwd = _mm256_set1_ps(lr * weight_decay);
    const __m256 vrsqrt_bc2 = _mm256_set1_ps(1.f / std::sqrt(bc2));
    int64_t i = lo;
    for (; i + kWidth <= hi; i += kWidth) {
        __m256 vp = _mm256_loadu_ps(p + i);
        __m256 vg = _mm256_loadu_ps(g + i);
        if (!adamw && weight_decay > 0.f) vg = _mm256_fmadd_ps(vwd, vp, vg);
        __m256 vm = _mm256_fmadd_ps(vb1, _mm256_loadu_ps(m + i), _mm256_mul_ps(vomb1, vg));
        __m256 vv = _mm256_fmadd_ps(vb2, _mm256_loadu_ps(v + i),
                                    _mm256_mul_ps(vomb2, _mm256_mul_ps(vg, vg)));
        _mm256_storeu_ps(m + i, vm);
        _mm256_storeu_ps(v + i, vv);
        __m256 denom = _mm256_add_ps(_mm256_mul_ps(_mm256_sqrt_ps(vv), vrsqrt_bc2), veps);
        __m256 upd = _mm256_div_ps(vm, denom);
        if (adamw && weight_decay > 0.f) vp = _mm256_fnmadd_ps(vlrwd, vp, vp);
        _mm256_storeu_ps(p + i, _mm256_fmadd_ps(vstep, upd, vp));
    }
    adam_scalar(p, g, m, v, i, hi, lr, beta1, beta2, eps, weight_decay, bc1, bc2, adamw);
}
#else
void adam_simd(float* p, const float* g, float* m, float* v, int64_t lo, int64_t hi,
               float lr, float beta1, float beta2, float eps, float weight_decay,
               float bc1, float bc2, bool adamw) {
    adam_scalar(p, g, m, v, lo, hi, lr, beta1, beta2, eps, weight_decay, bc1, bc2, adamw);
}
#endif

constexpr int64_t kParallelThreshold = 1 << 20;  // 1M elements

template <typename Fn>
void parallel_for(int64_t n, Fn body) {
    if (n < kParallelThreshold) {
        body(0, n);
        return;
    }
    int threads = std::min<int64_t>(std::thread::hardware_concurrency(), 8);
    if (threads < 2) {
        body(0, n);
        return;
    }
    std::vector<std::thread> pool;
    int64_t chunk = (n + threads - 1) / threads;
    chunk = (chunk + 63) & ~int64_t(63);  // cache-line-multiple split points
    for (int t = 0; t < threads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        pool.emplace_back([=] { body(lo, hi); });
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Mirrors the reference bindings (csrc/adam/cpu_adam.cpp:8-15):
// create_adam / adam_update / destroy_adam keyed by optimizer_id.
int create_adam(int optimizer_id, float lr, float beta1, float beta2, float eps,
                float weight_decay, int adamw_mode) {
    std::lock_guard<std::mutex> lk(g_mu);
    g_optimizers[optimizer_id] = AdamState{lr, beta1, beta2, eps, weight_decay, adamw_mode != 0};
    return 0;
}

int destroy_adam(int optimizer_id) {
    std::lock_guard<std::mutex> lk(g_mu);
    g_optimizers.erase(optimizer_id);
    return 0;
}

// One fused update over a flat fp32 partition. `step` is 1-based.
int adam_update(int optimizer_id, int64_t step, float lr, float beta1, float beta2, float eps,
                float weight_decay, int bias_correction, float* params, const float* grads,
                float* exp_avg, float* exp_avg_sq, int64_t n) {
    bool adamw;
    {
        std::lock_guard<std::mutex> lk(g_mu);
        auto it = g_optimizers.find(optimizer_id);
        if (it == g_optimizers.end()) return -1;
        adamw = it->second.adamw_mode;
    }
    float bc1 = 1.f, bc2 = 1.f;
    if (bias_correction) {
        bc1 = 1.f - std::pow(beta1, static_cast<float>(step));
        bc2 = 1.f - std::pow(beta2, static_cast<float>(step));
    }
    parallel_for(n, [&](int64_t lo, int64_t hi) {
        adam_simd(params, grads, exp_avg, exp_avg_sq, lo, hi, lr, beta1, beta2, eps,
                  weight_decay, bc1, bc2, adamw);
    });
    return 0;
}

// Returns the SIMD lane width compiled in (16 = AVX-512, 8 = AVX2, 1 = scalar).
int adam_simd_width() {
#if defined(__AVX512F__)
    return 16;
#elif defined(__AVX2__)
    return 8;
#else
    return 1;
#endif
}

}  // extern "C"
