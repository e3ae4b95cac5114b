/* aquery2_tpu_torch user-module C ABI (the JAX package's, unchanged).
 *
 * Counterpart of the reference's sdk/aquery.h (vector_type-based C++ ABI
 * for dlopen'd modules, server.cpp:308-331). The engine's columns live on
 * the device, so a module gets host copies as plain C buffers:
 *
 *   scalar params      → by value (int32_t/int64_t/float/double/bool)
 *   vec<T> param       → const T* data, int64_t len
 *   vecvec<T> param    → const T* data, int64_t rows, int64_t cols
 *                        (row-major, uniform width)
 *   scalar return      → plain return value
 *   vec<T> return      → int64_t f(..., T* out, int64_t out_cap);
 *                        fill `out`, return the element count
 *
 * Functions are exported with AQ_EXPORT and registered from SQL:
 *
 *   LOAD MODULE FROM "./libmymod.so" FUNCTIONS (
 *       mydiv(a:int, b:int) -> double,
 *       mulvec(a:int, b:vecfloat) -> vecfloat
 *   );
 *
 * Build: g++ -O3 -fPIC -shared -o libmymod.so mymod.cpp
 */
#ifndef AQUERY_TPU_MODULE_H
#define AQUERY_TPU_MODULE_H

#include <stdint.h>

#ifdef __cplusplus
#define AQ_EXPORT extern "C" __attribute__((visibility("default")))
#else
#define AQ_EXPORT __attribute__((visibility("default")))
#endif

#endif /* AQUERY_TPU_MODULE_H */
