// Vectorized host Adagrad for offloaded optimizer state.
//
// The port's copy of the JAX package's csrc/adagrad/cpu_adagrad.cpp, code
// unchanged: same host-DRAM partition contract as cpu_adam.cpp, single
// accumulator state. -O3 -march=native autovectorizes this simple kernel.

#include <cmath>
#include <cstdint>
#include <mutex>
#include <unordered_map>

namespace {

struct AdagradState {
    float lr;
    float eps;
    float weight_decay;
};

std::unordered_map<int, AdagradState> g_optimizers;
std::mutex g_mu;

}  // namespace

extern "C" {

int create_adagrad(int optimizer_id, float lr, float eps, float weight_decay) {
    std::lock_guard<std::mutex> lk(g_mu);
    g_optimizers[optimizer_id] = AdagradState{lr, eps, weight_decay};
    return 0;
}

int destroy_adagrad(int optimizer_id) {
    std::lock_guard<std::mutex> lk(g_mu);
    g_optimizers.erase(optimizer_id);
    return 0;
}

int adagrad_update(int optimizer_id, float lr, float eps, float weight_decay, float* params,
                   const float* grads, float* accum, int64_t n) {
    {
        std::lock_guard<std::mutex> lk(g_mu);
        if (g_optimizers.find(optimizer_id) == g_optimizers.end()) return -1;
    }
    for (int64_t i = 0; i < n; ++i) {
        float grad = grads[i];
        if (weight_decay > 0.f) grad += weight_decay * params[i];
        accum[i] += grad * grad;
        params[i] -= lr * grad / (std::sqrt(accum[i]) + eps);
    }
    return 0;
}

}  // extern "C"
