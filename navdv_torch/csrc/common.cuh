// Shared by every kernel library of navdv_torch: a plain C interface, one
// launcher per kernel that returns the cudaError_t of its launch, and the
// error-string lookup the Python wrappers use to raise.
#pragma once

#include <cuda_runtime.h>

#define NAVDV_EXPORT extern "C" __attribute__((visibility("default")))

NAVDV_EXPORT const char* navdv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
