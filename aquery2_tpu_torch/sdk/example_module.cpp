// Example user module (counterpart of the reference's sdk/example.cpp —
// `mydiv`/`mulvec` used by tests/modules.a).
//
// Build: g++ -O3 -fPIC -shared -o test_module.so example_module.cpp

#include "aquery_tpu_module.h"

AQ_EXPORT double mydiv(int32_t a, int32_t b) {
    return b == 0 ? 0.0 : (double)a / (double)b;
}

AQ_EXPORT int64_t mulvec(int32_t a, const float* b, int64_t len,
                         float* out, int64_t out_cap) {
    int64_t n = len < out_cap ? len : out_cap;
    for (int64_t i = 0; i < n; ++i) out[i] = a * b[i];
    return n;
}
