// Fused Taylor-mode FCNN forward for Hopper (sm_90a).
//
// Replaces the TPU kernel neurodiffeq_tpu/ops/pallas_mlp.py::_kernel
// (launched by _pallas_call through fcnn_taylor_pallas). For a tile of
// collocation points it evaluates an L-layer FCNN with tanh or sin between
// layers and returns the value c0 (N, out) and the first and second
// directional derivatives c1, c2 (D, N, out) along the D = d coordinate
// axes. The math is exactly the plain twin
// neurodiffeq_tpu_torch/ops/taylor_mlp.py::fcnn_taylor_reference:
//   first layer:  z = x.W1 + b1, a = f(z), u1_d = f'(z) W1[d,:],
//                 u2_d = f''(z) W1[d,:]^2   (tangents are the rows of W1);
//   middle layer: z_s = stream_s.W (+ b for the value stream), a = f(z_0),
//                 u1_d = f' z1_d,  u2_d = f' z2_d + f'' z1_d^2;
//   output layer: every stream times W_L (+ b_L for the value).
// Activation derivatives reuse the forward value: tanh f' = 1 - a^2,
// f'' = -2 a f'; sin f' = cos z, f'' = -a.
//
// What bounds it on this card: at the flagship shape (2-512-1, tanh,
// order 2, N = 1024) the work is a K=2 dot per hidden unit, three
// transcendental-bound elementwise streams and an N=1 reduction over 512
// units: about 5 MFLOP in all, far below what a tensor core would help
// with. The kernel is latency- and launch-bound, not GEMM-bound. The design
// therefore keeps everything of one tile on chip: one block per tile of T
// points, threads over (point, unit) pairs, the 1+2D streams of the current
// layer in dynamic shared memory (never in device memory), and the output
// layer as one warp-shuffle reduction per (stream, point, output unit).
// One launch replaces the ~20 separate elementwise and matmul launches of
// the plain twin. No tensor cores, no TMA: making it fast is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kMaxDims = 8;                 // input dimension d = directions D
constexpr int kMaxStreams = 1 + 2 * kMaxDims;
constexpr int kActTanh = 0;
constexpr int kActSin = 1;

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

template <typename T>
__device__ __forceinline__ void actv_chain(T z, int actv, T& a, T& f1, T& f2) {
  if (actv == kActTanh) {
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
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Streams of one layer live in shared memory as buf[(s * tile + t) * width + j]:
// s = 0 the value a, s = 1..D the first-order tangents, s = D+1..2D the
// second-order ones.
template <typename T>
__global__ void taylor_mlp_kernel(const T* __restrict__ x, int n, int d, int n_layers,
                                  MLPParams<T> p, int order, int actv, int tile, int hmax,
                                  T* __restrict__ c0, T* __restrict__ c1, T* __restrict__ c2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int S = 1 + order * d;
  const int n0 = blockIdx.x * tile;
  const int n_out = p.dims[n_layers];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  if (n_layers == 1) {  // a single affine layer: constant tangents, zero curvature
    const T* W = p.W[0];
    for (int idx = tid; idx < tile * n_out; idx += nthreads) {
      const int t = idx / n_out, o = idx % n_out, pt = n0 + t;
      if (pt >= n) continue;
      const T* w = W + o * d;
      T z = p.b[0][o];
      for (int k = 0; k < d; ++k) z += x[pt * d + k] * w[k];
      c0[pt * n_out + o] = z;
      for (int dd = 0; dd < d; ++dd) {
        const size_t off = (static_cast<size_t>(dd) * n + pt) * n_out + o;
        c1[off] = w[dd];
        if (order >= 2) c2[off] = T(0);
      }
    }
    return;
  }

  T* buf[2] = {smem, smem + static_cast<size_t>(S) * tile * hmax};

  // ---- first layer: K = d dot per (point, unit); tangents are rows of W1
  {
    const int h = p.dims[1];
    const T* W = p.W[0];
    T* out = buf[0];
    for (int idx = tid; idx < tile * h; idx += nthreads) {
      const int t = idx / h, j = idx % h, pt = n0 + t;
      const T* w = W + j * d;
      T z = p.b[0][j];
      if (pt < n) {
        for (int k = 0; k < d; ++k) z += x[pt * d + k] * w[k];
      }
      T a, f1, f2;
      actv_chain(z, actv, a, f1, f2);
      out[t * h + j] = a;
      for (int dd = 0; dd < d; ++dd) {
        const T wd = w[dd];
        out[((1 + dd) * tile + t) * h + j] = f1 * wd;
        if (order >= 2) out[((1 + d + dd) * tile + t) * h + j] = f2 * wd * wd;
      }
    }
  }
  __syncthreads();

  // ---- middle layers: 1 + order*D dots per (point, unit), then the chain rule
  int cur = 0;
  for (int l = 1; l < n_layers - 1; ++l) {
    const int hin = p.dims[l], hout = p.dims[l + 1];
    const T* W = p.W[l];
    const T* in = buf[cur];
    T* out = buf[cur ^ 1];
    for (int idx = tid; idx < tile * hout; idx += nthreads) {
      const int t = idx / hout, j = idx % hout;
      const T* w = W + static_cast<size_t>(j) * hin;
      T z[kMaxStreams];
      for (int s = 0; s < S; ++s) z[s] = T(0);
      for (int k = 0; k < hin; ++k) {
        const T wk = w[k];
        for (int s = 0; s < S; ++s) z[s] += in[(s * tile + t) * hin + k] * wk;
      }
      T a, f1, f2;
      actv_chain(z[0] + p.b[l][j], actv, a, f1, f2);
      out[t * hout + j] = a;
      for (int dd = 0; dd < d; ++dd) {
        const T z1 = z[1 + dd];
        out[((1 + dd) * tile + t) * hout + j] = f1 * z1;
        if (order >= 2) out[((1 + d + dd) * tile + t) * hout + j] = f1 * z[1 + d + dd] + f2 * z1 * z1;
      }
    }
    __syncthreads();
    cur ^= 1;
  }

  // ---- output layer: one warp reduces over H per (stream, point, output unit)
  {
    const int hin = p.dims[n_layers - 1];
    const T* W = p.W[n_layers - 1];
    const T* in = buf[cur];
    const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
    for (int r = warp; r < S * tile * n_out; r += nwarps) {
      const int s = r / (tile * n_out), rem = r % (tile * n_out);
      const int t = rem / n_out, o = rem % n_out, pt = n0 + t;
      const T* row = in + (s * tile + t) * hin;
      const T* w = W + static_cast<size_t>(o) * hin;
      T acc = T(0);
      for (int k = lane; k < hin; k += 32) acc += row[k] * w[k];
      acc = warp_sum(acc);
      if (lane == 0 && pt < n) {
        if (s == 0) {
          c0[pt * n_out + o] = acc + p.b[n_layers - 1][o];
        } else if (s <= d) {
          c1[(static_cast<size_t>(s - 1) * n + pt) * n_out + o] = acc;
        } else {
          c2[(static_cast<size_t>(s - 1 - d) * n + pt) * n_out + o] = acc;
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, int n, int d, int n_layers, const int* dims, const void* const* W,
           const void* const* b, int order, int actv, int tile, int threads, int smem_bytes,
           void* c0, void* c1, void* c2, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || d < 1 || d > kMaxDims || order < 1 || order > 2 ||
      tile < 1 || threads < 32 || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MLPParams<T> p;
  int hmax = 1;
  for (int l = 0; l < n_layers; ++l) {
    p.W[l] = static_cast<const T*>(W[l]);
    p.b[l] = static_cast<const T*>(b[l]);
  }
  for (int l = 0; l <= n_layers; ++l) {
    p.dims[l] = dims[l];
    if (l > 0 && l < n_layers && dims[l] > hmax) hmax = dims[l];
  }
  cudaError_t err = cudaFuncSetAttribute(taylor_mlp_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + tile - 1) / tile;
  taylor_mlp_kernel<T><<<blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), n, d, n_layers, p, order, actv, tile, hmax, static_cast<T*>(c0),
      static_cast<T*>(c1), static_cast<T*>(c2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success). Pointers are
// device pointers except `dims`, `W` and `b`, which are host arrays of
// n_layers + 1 ints and n_layers device pointers.
int taylor_mlp_forward_f32(const void* x, int n, int d, int n_layers, const int* dims,
                           const void* const* W, const void* const* b, int order, int actv,
                           int tile, int threads, int smem_bytes, void* c0, void* c1, void* c2,
                           void* stream) {
  return launch<float>(x, n, d, n_layers, dims, W, b, order, actv, tile, threads, smem_bytes, c0,
                       c1, c2, stream);
}

int taylor_mlp_forward_f64(const void* x, int n, int d, int n_layers, const int* dims,
                           const void* const* W, const void* const* b, int order, int actv,
                           int tile, int threads, int smem_bytes, void* c0, void* c1, void* c2,
                           void* stream) {
  return launch<double>(x, n, d, n_layers, dims, W, b, order, actv, tile, threads, smem_bytes, c0,
                        c1, c2, stream);
}

}  // extern "C"
