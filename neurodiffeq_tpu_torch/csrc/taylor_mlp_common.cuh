// What the Taylor-MLP kernel sources share: the limits, the parameters of a
// launch, the activations with their derivatives, cp.async, the direction
// chunks and the dispatch over (directions, order). Included by
// taylor_mlp.cu and taylor_mlp_streams.cu, each one translation unit.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 128;    // MLPParams, passed by value, stays under 4 KB of kernel parameters
constexpr int kMaxDims = 8;        // directions D of one launch's chunk
constexpr int kMaxGridYZ = 65535;  // CUDA's bound on a grid's y and z extents
constexpr int kMaxDevices = 64;
constexpr int kSmemLimit = 232448; // dynamic shared memory a block may use on sm_90
constexpr int kActTanh = 0;
constexpr int kActSin = 1;
constexpr int kActNone = -1;  // taylor_mlp_streams: no input activation
constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <typename T>
struct MLPParams {
  const T* W[kMaxLayers];   // layer l weight, (dims[l+1], dims[l]) row-major (nn.Linear layout)
  const T* b[kMaxLayers];   // layer l bias, (dims[l+1],)
  int dims[kMaxLayers + 1];
};

__device__ __forceinline__ float dev_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double dev_tanh(double x) { return tanh(x); }
__device__ __forceinline__ float dev_sin(float x) { return sinf(x); }
__device__ __forceinline__ double dev_sin(double x) { return sin(x); }
__device__ __forceinline__ float dev_cos(float x) { return cosf(x); }
__device__ __forceinline__ double dev_cos(double x) { return cos(x); }

template <int ACT, typename T>
__device__ __forceinline__ void actv_chain(T z, T& a, T& f1, T& f2) {
  if constexpr (ACT == kActTanh) {
    a = dev_tanh(z);
    f1 = T(1) - a * a;
    f2 = T(-2) * a * f1;
  } else {
    a = dev_sin(z);
    f1 = dev_cos(z);
    f2 = -a;
  }
}

template <typename T>
__device__ __forceinline__ void actv_chain(T z, int actv, T& a, T& f1, T& f2) {
  if (actv == kActTanh) {
    actv_chain<kActTanh>(z, a, f1, f2);
  } else {
    actv_chain<kActSin>(z, a, f1, f2);
  }
}

// One element from global to shared memory, asynchronously (4 or 8 bytes).
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(saddr), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(saddr), "l"(src));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// ---------------------------------------------------------------- direction chunks
// The first of the D directions of the block's chunk: chunks of D, the last
// shifted back so that it ends at d. Only a D = kMaxDims instance runs more
// than one chunk; the others keep their output pointers as given (shifting
// them slows their stores) and every block stores c0.
template <int D>
__device__ __forceinline__ int chunk_dir0(int d, unsigned chunk) {
  if constexpr (D == kMaxDims) return min(static_cast<int>(chunk) * D, d - D);
  return 0;
}

// Direction chunks of a launch for d inputs (dispatch takes at most kMaxGridYZ).
__host__ __device__ inline int chunks_of(int d) { return (d + kMaxDims - 1) / kMaxDims; }

// Calls F<D, ORDER>::run(args...) for D = min(d, kMaxDims) and the runtime order.
template <template <int, int> class F, typename... A>
int dispatch(int d, int order, A... args) {
  if (order != 1 && order != 2) return kInvalid;
  if (d < 1 || chunks_of(d) > kMaxGridYZ) return kInvalid;
#define NDTORCH_CASE(DD)                                                                \
  case DD:                                                                              \
    return order == 1 ? F<DD, 1>::run(args...) : F<DD, 2>::run(args...);
  switch (d < kMaxDims ? d : kMaxDims) {
    NDTORCH_CASE(1) NDTORCH_CASE(2) NDTORCH_CASE(3) NDTORCH_CASE(4)
    NDTORCH_CASE(5) NDTORCH_CASE(6) NDTORCH_CASE(7) NDTORCH_CASE(8)
    default:
      return kInvalid;
  }
#undef NDTORCH_CASE
}

}  // namespace
