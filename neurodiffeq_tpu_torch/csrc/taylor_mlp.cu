// Fused Taylor-mode FCNN forward for Hopper (sm_90a): three kernel entries
// (taylor_mlp_streams.cu holds a fourth), and the backward of the one-hidden-
// layer net (taylor_mlp_1h_bwd).
//
// taylor_mlp_1h and taylor_mlp replace the TPU kernel
// neurodiffeq_tpu/ops/pallas_mlp.py::_kernel (launched by _pallas_call
// through fcnn_taylor_pallas). For a tile of
// collocation points they evaluate an L-layer FCNN with tanh or sin between
// layers and return the value c0 (N, out) and the first and second
// directional derivatives c1, c2 (D, N, out) along the D = d coordinate
// axes. The math is the plain twin
// neurodiffeq_tpu_torch/ops/taylor_mlp.py::fcnn_taylor_reference:
//   first layer:  z = x.W1 + b1, a = f(z), u1_d = f'(z) W1[d,:],
//                 u2_d = f''(z) W1[d,:]^2   (tangents are the rows of W1);
//   middle layer: z_s = stream_s.W (+ b for the value stream), a = f(z_0),
//                 u1_d = f' z1_d,  u2_d = f' z2_d + f'' z1_d^2;
//   output layer: every stream times W_L (+ b_L for the value).
// Activation derivatives reuse the forward value: tanh f' = 1 - a^2,
// f'' = -2 a f'; sin f' = cos z, f'' = -a.
//
// What bounds them on this card. Per point and hidden unit the flagship
// (2-512-1, tanh, order 2) does about 25 floating-point operations and one
// tanh on a few KB of inputs: it is bound by FMA and SFU work, and at the
// main path's N = 1024 (13 MFLOP, 0.2 us at 67 TFLOP/s) by the latency of
// one launch. Tensor cores and TMA do not apply: the first layer has K = d
// <= 8 and the flagship's output layer N = 1, neither a matrix product a
// tensor core takes; float32 stays full precision (TF32 is off in the port,
// and 3xTF32 needs its own precision argument); the inputs are too small to
// need a bulk copy engine.
//
// taylor_mlp_1h_kernel (one hidden layer, the main path). The output layer
// is folded into per-unit constants: with v = W2[o, j], unit j adds a_j v to
// c0, f'_j (W1[d,j] v) to c1_d and f''_j (W1[d,j]^2 v) to c2_d. A thread
// owns a strided set of units, keeps each unit's W1 row, b1, v, W1 v and
// W1^2 v in registers, and loops over the tile's points, accumulating
// tile x (1 + order d) <= 32 partial sums in registers. The streams never
// leave registers: only x of the tile and one partial per warp and entry
// go through shared memory. A transposing warp sum (31 shuffles for all 32
// entries, where one warp sum per entry would take 5 each) and then a
// fixed-order sum over warps reduce; no atomics, so two launches give
// bitwise-equal outputs. Output units are the grid's y axis, so the
// accumulators do not grow with n_out.
//
// taylor_mlp_kernel (no hidden layer, or two and more). A middle layer is a
// product (S tile, h_in) x (h_in, h_out) over the S = 1 + order d stacked
// streams, which stay in shared memory (two buffers, read and write). W_l
// is staged in k-tiles of kKTile rows, transposed to k-major with a padded
// row so that the loads of a warp's 32 units are free of bank conflicts,
// by cp.async; the next tile (of this layer, or the next layer's first) is
// in flight while the current one is multiplied. A warp owns its points,
// a lane kUnitsPerLane units of a kChunk-unit chunk: each shared-memory
// load of a stream value feeds kUnitsPerLane FMAs and each weight load
// points x S of them. The chain rule is the epilogue of each layer. The
// output layer is one warp reduction per (point, output unit) over all S
// streams at once.
//
// Reach: any input width, 1-kMaxLayers layers and any hidden width, as the
// TPU kernel. A launch carries D = min(d, kMaxDims) directions; for d > kMaxDims
// a grid axis (z for taylor_mlp_1h, y for taylor_mlp) runs ceil(d / kMaxDims)
// chunks of kMaxDims directions, the last one shifted back to end at d, and
// every chunk recomputes the value stream (only chunk 0 stores c0). Hidden
// widths whose streams do not fit a block's shared memory keep them in a
// global scratch instead (one region per resident block, which then loops
// over point tiles); the weight tiles stay in shared memory.
//
// taylor_mlp_streams_staged: the same function on input Taylor streams
// (1 + order d, N, h_in), after an optional input activation, for the shapes
// whose weights cannot stay resident in shared memory, where the
// taylor_mlp_streams kernel of taylor_mlp_streams.cu takes them (that
// file's header has the design; ops/taylor_mlp.py::_plan_streams routes by
// shape). It is taylor_mlp_kernel with its first layer replaced by a load of
// the tile's input streams into shared memory (STREAMS): every layer but the
// output layer then runs on the staged weight tiles.
//
// taylor_mlp_1h_bwd (the gradient of taylor_mlp_1h's outputs with respect
// to W1, b1, W2, b2 and, where asked, the points). It replaces no TPU kernel:
// the JAX package differentiates its pure-JAX twin (pallas_mlp.py's
// _fused_bwd, jax.vjp), and autograd over the port's twin materialised
// z, f, f', f'' and the (d, N, h) tangent streams and their cotangents,
// gigabytes at the flagship's 262,144 points, to produce about 1,500
// numbers. Here the hidden layer is rematerialised in registers: per (point,
// unit) about 60 operations (the 2-512-1 flagship, order 2) on the point's
// coordinates and the 1 + 2d cotangents, so it is bound by FMA work (0.12 ms
// at 262,144 points and 67 TFLOP/s) and reads a few MB. Design: a thread
// owns a hidden unit (blocks of up to 128), a block a span of points, staged
// in shared memory a sub-tile at a time, and the unit's partial sums of dW1,
// db1 and its output tile's dW2 stay in registers across the span. Each
// block writes them to its own slab of a scratch; a second small kernel adds
// the slabs in a fixed order (a tree of 16 lanes per element). Every term
// is linear in the cotangents, so output tiles (MT = 1, 4 or 16 columns of
// W2) and, past 8 inputs, direction chunks lie on grid axes of their own and
// their partial sums add. No atomics: two launches give bitwise-equal
// gradients. The points' gradient, a sum over units per point, is compiled in
// only where asked (PGRAD).
//
// No integer division by a runtime width in an inner loop: divisors are
// compile-time constants (D, S, kKTile).
#include "taylor_mlp_common.cuh"

namespace {

constexpr int kMaxThreads = 256;   // threads of a block, both kernels
constexpr int kKTile = 16;         // rows (k) of one staged weight tile
constexpr int kUnitsPerLane = 4;
constexpr int kChunk = 32 * kUnitsPerLane;  // output units of one pass
constexpr int kWStride = kChunk + 1;        // padded row of a staged weight tile
static_assert(kUnitsPerLane == 4, "taylor_mlp_kernel dispatches mac_w_tile over 1-4 unit groups");

// Points of a tile the 1h kernel keeps accumulators for (S of them each, 32
// in all at most); points a warp of the general kernel owns. The planner in ops/taylor_mlp.py repeats both.
__host__ __device__ constexpr int max_tile_1h(int s) { return 32 / s; }
__host__ __device__ constexpr int points_per_warp(int s) { return s <= 5 ? 2 : 1; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stream s of point pt goes to c0 (s = 0), c1 (s = 1..D) or c2.
template <typename T, int D>
__device__ __forceinline__ void store_stream(int s, int pt, int n, int n_out, int o, T v,
                                             T* c0, T* c1, T* c2) {
  if (s == 0) {
    c0[static_cast<size_t>(pt) * n_out + o] = v;
  } else if (s <= D) {
    c1[(static_cast<size_t>(s - 1) * n + pt) * n_out + o] = v;
  } else {
    c2[(static_cast<size_t>(s - 1 - D) * n + pt) * n_out + o] = v;
  }
}

// One step of warp_transpose_sum: a lane and its partner across lane bit
// OFF hold the same OFF * 2 entries; the lower keeps the first half, the
// upper the second, each adding the partner's copy of it.
template <typename T, int OFF>
__device__ __forceinline__ void transpose_step(T (&v)[32], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const T send = upper ? v[i] : v[i + OFF];
    const T keep = upper ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Sums each of the 32 entries of v over the warp; lane l gets entry l's
// sum. 31 shuffles in a fixed order, against 5 for every entry summed alone.
template <typename T>
__device__ __forceinline__ T warp_transpose_sum(T (&v)[32], int lane) {
  transpose_step<T, 16>(v, lane);
  transpose_step<T, 8>(v, lane);
  transpose_step<T, 4>(v, lane);
  transpose_step<T, 2>(v, lane);
  transpose_step<T, 1>(v, lane);
  return v[0];
}

// ---------------------------------------------------------------- one hidden layer
// acc[t * S + s] += stream s of the tile's point t over the units this
// thread owns. NARROW: d == D, the tile's points are in xr. Otherwise (D ==
// kMaxDims < d) z reads each point's row of x, and the tangents are the
// chunk's columns dir0.. of W1.
template <typename T, int D, int ORDER, int ACT, bool NARROW>
__device__ __forceinline__ void accumulate_1h(T (&acc)[32], const T (&xr)[max_tile_1h(1 + ORDER * D)][D],
                                              const T* x, int n, int n0, int d, int dir0, int h,
                                              int tile, const T* W1, const T* b1, const T* W2v) {
  constexpr int S = 1 + ORDER * D;
  constexpr int TM = max_tile_1h(S);
  const int stride = NARROW ? D : d;
  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    const T v = W2v[j];
    const T bj = b1[j];
    const T* wrow = W1 + static_cast<size_t>(j) * stride;
    T w[D], wv[D], wwv[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      w[k] = wrow[(NARROW ? 0 : dir0) + k];
      wv[k] = w[k] * v;
      wwv[k] = (w[k] * w[k]) * v;
    }
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      if (t < tile) {
        T z = bj;
        if constexpr (NARROW) {
#pragma unroll
          for (int k = 0; k < D; ++k) z += xr[t][k] * w[k];
        } else {
          const T* xp = x + static_cast<size_t>(min(n0 + t, n - 1)) * d;
          for (int k = 0; k < d; ++k) z += xp[k] * wrow[k];
        }
        T a, f1, f2;
        actv_chain<ACT>(z, a, f1, f2);
        acc[t * S] += a * v;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          acc[t * S + 1 + k] += f1 * wv[k];
          if constexpr (ORDER == 2) acc[t * S + 1 + D + k] += f2 * wwv[k];
        }
      }
    }
  }
}

// acc[t * S + s] is stream s of the tile's point t; TM * S <= 32 entries.
// Grid: (point tiles, output units, direction chunks).
template <typename T, int D, int ORDER, int ACT>
__global__ void __launch_bounds__(kMaxThreads)
taylor_mlp_1h_kernel(const T* __restrict__ x, int n, int d, int h, int n_out, const T* __restrict__ W1,
                     const T* __restrict__ b1, const T* __restrict__ W2, const T* __restrict__ b2,
                     int tile, T* __restrict__ c0, T* __restrict__ c1, T* __restrict__ c2) {
  constexpr int S = 1 + ORDER * D;
  constexpr int TM = max_tile_1h(S);
  __shared__ T xs[TM * D];
  __shared__ T red[kMaxThreads / 32][32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int n0 = blockIdx.x * tile, o = blockIdx.y;
  const int dir0 = chunk_dir0<D>(d, blockIdx.z);
  const bool store_c0 = D != kMaxDims || blockIdx.z == 0;
  if constexpr (D == kMaxDims) {  // this chunk's tangents
    c1 += static_cast<size_t>(dir0) * n * n_out;
    if constexpr (ORDER == 2) c2 += static_cast<size_t>(dir0) * n * n_out;
  }

  T acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = T(0);
  T xr[TM][D];  // the tile's points, in registers for the loop over units
  bool narrow = true;
  if constexpr (D == kMaxDims) narrow = d == D;
  if (narrow) {
    for (int i = tid; i < tile * D; i += blockDim.x) {
      xs[i] = n0 + i / D < n ? x[static_cast<size_t>(n0) * D + i] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < TM; ++t) {
#pragma unroll
      for (int k = 0; k < D; ++k) xr[t][k] = xs[t * D + k];
    }
    accumulate_1h<T, D, ORDER, ACT, true>(acc, xr, x, n, n0, d, dir0, h, tile, W1, b1,
                                          W2 + static_cast<size_t>(o) * h);
  } else if constexpr (D == kMaxDims) {
    accumulate_1h<T, D, ORDER, ACT, false>(acc, xr, x, n, n0, d, dir0, h, tile, W1, b1,
                                           W2 + static_cast<size_t>(o) * h);
  }

  red[warp][lane] = warp_transpose_sum(acc, lane);
  __syncthreads();
  if (tid < tile * S) {  // one thread per (point, stream); tile * S <= 32 <= blockDim.x
    T sum = red[0][tid];
    for (int w = 1; w < nwarps; ++w) sum += red[w][tid];
    const int t = tid / S, s = tid - t * S, pt = n0 + t;
    if (pt < n && (s != 0 || store_c0)) {
      store_stream<T, D>(s, pt, n, n_out, o, s == 0 ? sum + b2[o] : sum, c0, c1, c2);
    }
  }
}

// ---------------------------------------------------------------- general depth
// One staged weight tile: layer l, output units [j0, j0 + kChunk), inputs [k0, k0 + kKTile).
struct WTile {
  int l, j0, k0;
};

// The tile after `w` over the middle layers 1..n_layers-2, in the order the
// kernel consumes them; false past the last.
__device__ __forceinline__ bool next_tile(WTile& w, const int* dims, int n_layers) {
  w.k0 += kKTile;
  if (w.k0 < dims[w.l]) return true;
  w.k0 = 0;
  w.j0 += kChunk;
  if (w.j0 < dims[w.l + 1]) return true;
  w.j0 = 0;
  ++w.l;
  return w.l < n_layers - 1;
}

// 32-unit groups of the chunk at j0 that lie inside a layer of width hout.
__device__ __forceinline__ int unit_groups(int hout, int j0) {
  return min(kUnitsPerLane, (hout - j0 + 31) / 32);
}

// ws[kk * kWStride + jj] = W_l[j0 + jj, k0 + kk], zero outside the layer,
// for the chunk's unit groups that exist. Neighbouring threads read
// neighbouring k of one weight row.
template <typename T>
__device__ __forceinline__ void load_w_tile(T* ws, const MLPParams<T>& p, WTile w) {
  const int hin = p.dims[w.l], hout = p.dims[w.l + 1];
  const T* W = p.W[w.l];
  const int n_elems = kKTile * 32 * unit_groups(hout, w.j0);
  for (int i = threadIdx.x; i < n_elems; i += blockDim.x) {
    const int kk = i % kKTile, jj = i / kKTile;
    const int j = w.j0 + jj, k = w.k0 + kk;
    T* dst = ws + kk * kWStride + jj;
    if (j < hout && k < hin) {
      cp_async(dst, W + static_cast<size_t>(j) * hin + k);
    } else {
      *dst = T(0);
    }
  }
}

// acc[i][s][u] += the staged tile's kn rows of stream s of point i times
// the tile's column lane + 32 u, for the NU unit groups that exist. `in`
// points at the warp's first point and the tile's first row.
template <int NU, typename T, int TT, int S>
__device__ __forceinline__ void mac_w_tile(T (&acc)[TT][S][kUnitsPerLane], const T* in,
                                           const T* wt, int kn, int tile, int hstride) {
#pragma unroll 4
  for (int kk = 0; kk < kn; ++kk) {
    T wv[NU];
#pragma unroll
    for (int u = 0; u < NU; ++u) wv[u] = wt[kk * kWStride + 32 * u];
#pragma unroll
    for (int i = 0; i < TT; ++i) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const T a = in[(static_cast<size_t>(s) * tile + i) * hstride + kk];
#pragma unroll
        for (int u = 0; u < NU; ++u) acc[i][s][u] += a * wv[u];
      }
    }
  }
}

// The first layer's streams of point t for unit j: z is its pre-activation,
// w the unit's weights along the chunk's directions.
template <typename T, int D, int ORDER>
__device__ __forceinline__ void first_layer_streams(T* out, int tile, int hstride, int t, int j, T z,
                                                    const T (&w)[D], int actv) {
  T a, f1, f2;
  actv_chain(z, actv, a, f1, f2);
  out[static_cast<size_t>(t) * hstride + j] = a;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    out[(static_cast<size_t>(1 + k) * tile + t) * hstride + j] = f1 * w[k];
    if constexpr (ORDER == 2) out[(static_cast<size_t>(1 + D + k) * tile + t) * hstride + j] = f2 * (w[k] * w[k]);
  }
}

// The tile's input streams (STREAMS): stream s of point t and unit j of
// the (1 + order d, n, h) input `xs`, for the chunk's directions dir0..,
// through the input activation (kActNone: as they are) into out.
template <typename T, int D, int ORDER>
__device__ __forceinline__ void load_streams(T* out, const T* __restrict__ xs, int n, int d, int dir0, int h,
                                             int in_actv, int tile, int hstride, int n0) {
  constexpr int TT = points_per_warp(1 + ORDER * D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int t = warp * TT + i, pt = n0 + t;
    const bool in = pt < n;
    for (int j = lane; j < h; j += 32) {
      const T z0 = in ? xs[static_cast<size_t>(pt) * h + j] : T(0);
      T a = z0, f1 = T(1), f2 = T(0);
      if (in_actv != kActNone) actv_chain(z0, in_actv, a, f1, f2);
      out[static_cast<size_t>(t) * hstride + j] = a;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const T z1 = in ? xs[(static_cast<size_t>(1 + dir0 + k) * n + pt) * h + j] : T(0);
        out[(static_cast<size_t>(1 + k) * tile + t) * hstride + j] = f1 * z1;
        if constexpr (ORDER == 2) {
          const T z2 = in ? xs[(static_cast<size_t>(1 + d + dir0 + k) * n + pt) * h + j] : T(0);
          out[(static_cast<size_t>(1 + D + k) * tile + t) * hstride + j] = f1 * z2 + f2 * z1 * z1;
        }
      }
    }
  }
}

// Streams live as buf[(s * tile + t) * hstride + j]: s = 0 the value,
// s = 1..D the first-order tangents of the chunk's directions, s = D+1..2D
// the second-order ones. Warp w owns points t = w * TT .. w * TT + TT - 1
// of the tile at n0: every layer of those points, then their outputs. With
// STREAMS, x holds input streams and every layer but the last is a middle
// layer; otherwise x holds points and layer 0 is the first layer.
template <typename T, int D, int ORDER, bool STREAMS>
__device__ __forceinline__ void run_tile(int n0, const T* __restrict__ x, int n, int d, int dir0,
                                         int n_layers, const MLPParams<T>& p, int actv, int in_actv,
                                         int tile, int hstride, T* const* buf, T* const* ws, bool store_c0,
                                         T* __restrict__ c0, T* __restrict__ c1, T* __restrict__ c2) {
  constexpr int S = 1 + ORDER * D;
  constexpr int TT = points_per_warp(S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_out = p.dims[n_layers];
  // the first weight tile is in flight while the first layer (or the input streams' load) runs
  WTile cur{STREAMS ? 0 : 1, 0, 0};
  const bool any_middle = n_layers > (STREAMS ? 1 : 2);
  if (any_middle) load_w_tile(ws[0], p, cur);
  cp_async_commit();

  if constexpr (STREAMS) {
    load_streams<T, D, ORDER>(buf[0], x, n, d, dir0, p.dims[0], in_actv, tile, hstride, n0);
  } else {  // ---- first layer: K = d dot per (point, unit); tangents are the chunk's columns of W1
    const int h = p.dims[1];
    const T* W = p.W[0];
    const T* b = p.b[0];
    T* out = buf[0];
#pragma unroll
    for (int i = 0; i < TT; ++i) {
      const int t = warp * TT + i, pt = n0 + t;
      bool narrow = true;
      if constexpr (D == kMaxDims) narrow = d == D;
      if (narrow) {  // the point in registers; the tangents are whole rows of W1
        T xv[D];
#pragma unroll
        for (int k = 0; k < D; ++k) xv[k] = pt < n ? x[static_cast<size_t>(pt) * D + k] : T(0);
        for (int j = lane; j < h; j += 32) {
          T w[D];
          T z = T(0);
#pragma unroll
          for (int k = 0; k < D; ++k) {
            w[k] = W[static_cast<size_t>(j) * D + k];
            z += xv[k] * w[k];
          }
          first_layer_streams<T, D, ORDER>(out, tile, hstride, t, j, z + b[j], w, actv);
        }
      } else if constexpr (D == kMaxDims) {  // z over all d inputs; the chunk's columns of W1
        const T* xp = x + static_cast<size_t>(min(pt, n - 1)) * d;
        for (int j = lane; j < h; j += 32) {
          const T* wrow = W + static_cast<size_t>(j) * d;
          T z = T(0);
          for (int k = 0; k < d; ++k) z += (pt < n ? xp[k] : T(0)) * wrow[k];
          T w[D];
#pragma unroll
          for (int k = 0; k < D; ++k) w[k] = wrow[dir0 + k];
          first_layer_streams<T, D, ORDER>(out, tile, hstride, t, j, z + b[j], w, actv);
        }
      }
    }
  }

  // ---- middle layers: one staged weight tile per iteration
  int src = 0, stage = 0;
  T acc[TT][S][kUnitsPerLane];
  bool more = any_middle;
  while (more) {
    WTile nxt = cur;
    const bool has_next = next_tile(nxt, p.dims, n_layers);
    if (has_next) load_w_tile(ws[stage ^ 1], p, nxt);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int hin = p.dims[cur.l], hout = p.dims[cur.l + 1];
    if (cur.k0 == 0) {
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int s = 0; s < S; ++s)
#pragma unroll
          for (int u = 0; u < kUnitsPerLane; ++u) acc[i][s][u] = T(0);
    }
    const T* in = buf[src] + static_cast<size_t>(warp) * TT * hstride + cur.k0;
    const T* wt = ws[stage] + lane;
    const int kn = min(kKTile, hin - cur.k0);
    switch (unit_groups(hout, cur.j0)) {  // narrow layers skip the groups past their width
      case 1: mac_w_tile<1>(acc, in, wt, kn, tile, hstride); break;
      case 2: mac_w_tile<2>(acc, in, wt, kn, tile, hstride); break;
      case 3: mac_w_tile<3>(acc, in, wt, kn, tile, hstride); break;
      default: mac_w_tile<kUnitsPerLane>(acc, in, wt, kn, tile, hstride);
    }

    if (cur.k0 + kKTile >= hin) {  // the chunk's sums are complete: chain rule
      T* out = buf[src ^ 1];
      const T* b = p.b[cur.l];
#pragma unroll
      for (int u = 0; u < kUnitsPerLane; ++u) {
        const int j = cur.j0 + lane + 32 * u;
        if (j < hout) {
          const T bj = b[j];
#pragma unroll
          for (int i = 0; i < TT; ++i) {
            const int t = warp * TT + i;
            T a, f1, f2;
            actv_chain(acc[i][0][u] + bj, actv, a, f1, f2);
            out[static_cast<size_t>(t) * hstride + j] = a;
#pragma unroll
            for (int k = 0; k < D; ++k) {
              const T z1 = acc[i][1 + k][u];
              out[(static_cast<size_t>(1 + k) * tile + t) * hstride + j] = f1 * z1;
              if constexpr (ORDER == 2) {
                out[(static_cast<size_t>(1 + D + k) * tile + t) * hstride + j] =
                    f1 * acc[i][1 + D + k][u] + f2 * z1 * z1;
              }
            }
          }
        }
      }
      if (cur.j0 + kChunk >= hout) src ^= 1;  // layer done: its output is the next input
    }
    __syncthreads();  // the stage just read is the one the next iteration refills
    stage ^= 1;
    cur = nxt;
    more = has_next;
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- output layer: one warp reduction per (point, output unit), all streams at once
  {
    const int hin = p.dims[n_layers - 1];
    const T* W = p.W[n_layers - 1];
    const T* in = buf[src];
    for (int o = 0; o < n_out; ++o) {
      const T* w = W + static_cast<size_t>(o) * hin;
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        const int t = warp * TT + i, pt = n0 + t;
        T part[S];
#pragma unroll
        for (int s = 0; s < S; ++s) part[s] = T(0);
        for (int k = lane; k < hin; k += 32) {
          const T wk = w[k];
#pragma unroll
          for (int s = 0; s < S; ++s) part[s] += in[(static_cast<size_t>(s) * tile + t) * hstride + k] * wk;
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const T v = warp_sum(part[s]);
          if (lane == s && pt < n && (s != 0 || store_c0)) {
            store_stream<T, D>(s, pt, n, n_out, o, s == 0 ? v + p.b[n_layers - 1][o] : v, c0, c1, c2);
          }
        }
      }
    }
  }
}

// The streams are in shared memory, or with GSTREAMS in the block's region
// of the global scratch `gbuf` (a template flag, so that the shared
// variant's loads and stores stay shared-memory instructions; with it each
// block loops over every gridDim.x-th tile). Grid: (point tiles or resident
// blocks, direction chunks). STREAMS: taylor_mlp_streams, x the input
// streams, in_actv their activation (kActNone: none).
template <typename T, int D, int ORDER, bool GSTREAMS, bool STREAMS>
__global__ void __launch_bounds__(kMaxThreads)
taylor_mlp_kernel(const T* __restrict__ x, int n, int d, int n_layers, MLPParams<T> p, int actv,
                  int in_actv, int tile, int hstride, T* gbuf, T* __restrict__ c0, T* __restrict__ c1,
                  T* __restrict__ c2) {
  constexpr int S = 1 + ORDER * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int n_out = p.dims[n_layers];
  const int dir0 = chunk_dir0<D>(d, blockIdx.y);
  const bool store_c0 = D != kMaxDims || blockIdx.y == 0;
  if constexpr (D == kMaxDims) {  // this chunk's tangents
    c1 += static_cast<size_t>(dir0) * n * n_out;
    if constexpr (ORDER == 2) c2 += static_cast<size_t>(dir0) * n * n_out;
  }

  if (!STREAMS && n_layers == 1) {  // a single affine layer: constant tangents, zero curvature
    const T* W = p.W[0];
    const int n0 = blockIdx.x * tile;
    for (int t = warp; t < tile; t += nwarps) {
      const int pt = n0 + t;
      if (pt >= n) break;
      for (int o = lane; o < n_out; o += 32) {
        const T* w = W + static_cast<size_t>(o) * d;
        T z = p.b[0][o];
        for (int k = 0; k < d; ++k) z += x[static_cast<size_t>(pt) * d + k] * w[k];
        if (store_c0) c0[static_cast<size_t>(pt) * n_out + o] = z;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const size_t off = (static_cast<size_t>(k) * n + pt) * n_out + o;
          c1[off] = w[dir0 + k];
          if constexpr (ORDER == 2) c2[off] = T(0);
        }
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const size_t buf_elems = static_cast<size_t>(S) * tile * hstride;
  if constexpr (GSTREAMS) {
    T* region = gbuf + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 2 * buf_elems;
    T* const buf[2] = {region, region + buf_elems};
    T* const ws[2] = {smem, smem + kKTile * kWStride};
    for (int n0 = blockIdx.x * tile; n0 < n; n0 += gridDim.x * tile) {
      run_tile<T, D, ORDER, STREAMS>(n0, x, n, d, dir0, n_layers, p, actv, in_actv, tile, hstride, buf, ws,
                                     store_c0, c0, c1, c2);
      __syncthreads();  // the next tile's first layer overwrites the streams just read
    }
  } else {
    T* const buf[2] = {smem, smem + buf_elems};
    T* const ws[2] = {smem + 2 * buf_elems, smem + 2 * buf_elems + kKTile * kWStride};
    run_tile<T, D, ORDER, STREAMS>(blockIdx.x * tile, x, n, d, dir0, n_layers, p, actv, in_actv, tile, hstride,
                                   buf, ws, store_c0, c0, c1, c2);
  }
}

// ---------------------------------------------------------------- one hidden layer, backward
// Elements of one point's staged record (its D coordinates, the output
// tile's MT columns of c0's cotangent and of c1's and c2's along the D
// directions), and the points of a staged sub-tile: the largest power of
// two up to 64 whose records fit kBwdStage bytes. ops/taylor_mlp.py repeats both.
constexpr int kBwdThreads = 128;  // threads of a backward block, one hidden unit each
constexpr int kBwdStage = 24576;
constexpr int kSumLanes = 16;     // the sum pass: partial sums per element, summed as a tree
__host__ __device__ constexpr int bwd_rec(int d, int order, int mt) { return d + mt + order * d * mt; }
__host__ __device__ constexpr int bwd_tile(int rec, int esize) {
  int tp = 64;
  while (tp > 1 && tp * rec * esize > kBwdStage) tp /= 2;
  return tp;
}

// One point of the staged sub-tile `s`: x [TP][D], g0 [TP][MT], g1 and g2
// [D][TP][MT]. The chunk's directions are every direction (d == D).
template <typename T, int D, int MT, int TP>
struct StagedPoint {
  const T* s;
  int t;
  __device__ __forceinline__ T z(T bj, const T (&w)[D]) const {
    T z = bj;
#pragma unroll
    for (int k = 0; k < D; ++k) z += s[t * D + k] * w[k];
    return z;
  }
  __device__ __forceinline__ T x(int k) const { return s[t * D + k]; }
  __device__ __forceinline__ T g0(int o) const { return s[TP * D + t * MT + o]; }
  __device__ __forceinline__ T g1(int k, int o) const { return s[TP * (D + MT) + (k * TP + t) * MT + o]; }
  __device__ __forceinline__ T g2(int k, int o) const {
    return s[TP * (D + MT + D * MT) + (k * TP + t) * MT + o];
  }
  // r1 = sum over every direction k of W1[j, k] g1[k][o]; r2 the same with W1^2 and g2
  template <int ORDER>
  __device__ __forceinline__ void r(int o, const T (&w)[D], const T (&ww)[D], T& r1, T& r2) const {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      r1 += w[k] * g1(k, o);
      if constexpr (ORDER == 2) r2 += ww[k] * g2(k, o);
    }
  }
};

// One point when d > D (D == kMaxDims): its row of x, its cotangents and the
// unit's row of W1 read from global memory (a warp reads one address: L1
// broadcasts it). The chunk's directions are dir0 .. dir0 + D - 1; the sums
// r1, r2 and z run over all d.
template <typename T, int D, int MT>
struct GlobalPoint {
  const T *xp, *wrow, *g0p, *g1p, *g2p;  // g0p, g1p, g2p at the point's row, column o0; null: absent
  size_t dstride;                        // elements between two directions' rows of g1 and g2 (n m)
  int d, dir0, mvalid;                   // mvalid: columns of the tile inside the output layer
  __device__ __forceinline__ T z(T bj, const T (&)[D]) const {
    T z = bj;
    for (int k = 0; k < d; ++k) z += xp[k] * wrow[k];
    return z;
  }
  __device__ __forceinline__ T x(int k) const { return xp[dir0 + k]; }
  __device__ __forceinline__ T g0(int o) const { return g0p != nullptr && o < mvalid ? g0p[o] : T(0); }
  __device__ __forceinline__ T g1(int k, int o) const {
    return g1p != nullptr && o < mvalid ? g1p[(dir0 + k) * dstride + o] : T(0);
  }
  __device__ __forceinline__ T g2(int k, int o) const {
    return g2p != nullptr && o < mvalid ? g2p[(dir0 + k) * dstride + o] : T(0);
  }
  template <int ORDER>
  __device__ __forceinline__ void r(int o, const T (&)[D], const T (&)[D], T& r1, T& r2) const {
    if (o >= mvalid) return;
    for (int k = 0; k < d; ++k) {
      const T wk = wrow[k];
      if (g1p != nullptr) r1 += wk * g1p[k * dstride + o];
      if constexpr (ORDER == 2) {
        if (g2p != nullptr) r2 += (wk * wk) * g2p[k * dstride + o];
      }
    }
  }
};

// One point's part of unit j's gradient, for the output tile's columns o
// (v[o] = W2[o0 + o, j]). With p0 = sum_o v g0, q1 = sum_o v r1, q2 = sum_o
// v r2 and p1[k] = sum_o v g1[k][o], p2[k] likewise from g2:
//   dz      = f' p0 + f'' q1 + f''' q2          (the hidden pre-activation's cotangent)
//   dW2[o] += f g0[o] + f' r1[o] + f'' r2[o]
//   db1    += dz
//   dW1[k] += x[k] dz + f' p1[k] + 2 W1[j, k] f'' p2[k]
// Returns dz (the points' gradient is W1[:, k] dz summed over units).
template <typename T, int D, int ORDER, int MT, typename P>
__device__ __forceinline__ T point_bwd(const P& p, T bj, const T (&w)[D], const T (&ww)[D], const T (&w2x)[D],
                                       const T (&v)[MT], int actv, T (&aw1)[D], T& ab1, T (&aw2)[MT]) {
  const T z = p.z(bj, w);
  T a, f1, f2;
  actv_chain(z, actv, a, f1, f2);
  const T f3 = actv == kActTanh ? T(-2) * (f1 * f1 + a * f2) : -f1;
  T p0 = T(0), q1 = T(0), q2 = T(0), p1[D], p2[D];
#pragma unroll
  for (int k = 0; k < D; ++k) p1[k] = p2[k] = T(0);
#pragma unroll
  for (int o = 0; o < MT; ++o) {
    const T gz = p.g0(o);
    T r1 = T(0), r2 = T(0);
    p.template r<ORDER>(o, w, ww, r1, r2);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      p1[k] += v[o] * p.g1(k, o);
      if constexpr (ORDER == 2) p2[k] += v[o] * p.g2(k, o);
    }
    p0 += v[o] * gz;
    q1 += v[o] * r1;
    aw2[o] += a * gz + f1 * r1;
    if constexpr (ORDER == 2) {
      q2 += v[o] * r2;
      aw2[o] += f2 * r2;
    }
  }
  T dz = f1 * p0 + f2 * q1;
  if constexpr (ORDER == 2) dz += f3 * q2;
  ab1 += dz;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    aw1[k] += p.x(k) * dz + f1 * p1[k];
    if constexpr (ORDER == 2) aw1[k] += f2 * w2x[k] * p2[k];
  }
  return dz;
}

// Grid: (point blocks, unit tiles x output tiles, direction chunks). A block
// owns `span` points from blockIdx.x * span, its threads one hidden unit each
// (j = unit tile * blockDim.x + threadIdx.x) and the output tile's MT columns
// of W2 (o0 = output tile * MT). It walks its points in sub-tiles of TP,
// staged in shared memory (d == D) or read from global memory (d > D), and
// keeps every partial sum of its unit in registers. At the end it writes
// them to its slab of `part` (slab blockIdx.x * output tiles + output tile:
// dW1 (h, d) | db1 (h) | the tile's rows of dW2 (MT, h) | its db2 (MT)): dW1 for the chunk's own
// directions (the last chunk is shifted back; directions before c * D belong
// to the chunk before), db1 and the tile's columns of dW2 from chunk 0, the
// tile's db2 (a sum over the block's threads) from unit tile 0 of chunk 0.
// PGRAD: each sub-tile's points' gradient summed over the block's units,
// into slab blockIdx.y of gxp ((n, d) each), for the chunk's own directions.
// Every term is linear in the cotangents, so slabs add; the sum pass adds
// them in a fixed order. Units past h compute with v = 0 (so dz = 0) and
// store nothing.
template <typename T, int D, int ORDER, int MT, bool PGRAD>
__global__ void __launch_bounds__(kBwdThreads)
taylor_mlp_1h_bwd_kernel(const T* __restrict__ x, int n, int d, int h, int m, const T* __restrict__ W1,
                         const T* __restrict__ b1, const T* __restrict__ W2, int actv, int span,
                         const T* __restrict__ g0, const T* __restrict__ g1, const T* __restrict__ g2,
                         T* __restrict__ part, T* __restrict__ gxp) {
  constexpr int REC = bwd_rec(D, ORDER, MT);
  constexpr int TP = bwd_tile(REC, sizeof(T));
  static_assert(!PGRAD || TP * D >= MT, "red holds the tile's db2 too");
  __shared__ T st[TP * REC];
  __shared__ T red[kBwdThreads / 32][PGRAD ? TP * D : MT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int utn = (h + blockDim.x - 1) / blockDim.x;
  const int ut = blockIdx.y % utn, ot = blockIdx.y / utn, c = blockIdx.z;
  const int j = ut * blockDim.x + tid, jr = min(j, h - 1), o0 = ot * MT;
  const int dir0 = chunk_dir0<D>(d, c), own0 = c * D;
  const int n0 = blockIdx.x * span, n1 = min(n0 + span, n);
  const bool lead = ut == 0 && c == 0;  // sums the tile's db2
  bool narrow = true;
  if constexpr (D == kMaxDims) narrow = d == D;

  const T* wrow = W1 + static_cast<size_t>(jr) * d;
  const T bj = b1[jr];
  T w[D], ww[D], w2x[D], v[MT];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    w[k] = wrow[dir0 + k];
    ww[k] = w[k] * w[k];
    w2x[k] = T(2) * w[k];
  }
#pragma unroll
  for (int o = 0; o < MT; ++o) v[o] = j < h && o0 + o < m ? W2[static_cast<size_t>(o0 + o) * h + j] : T(0);
  T aw1[D], ab1 = T(0), aw2[MT], ab2[MT];
#pragma unroll
  for (int k = 0; k < D; ++k) aw1[k] = T(0);
#pragma unroll
  for (int o = 0; o < MT; ++o) aw2[o] = ab2[o] = T(0);

  for (int t0 = n0; t0 < n1; t0 += TP) {
    const int tp = min(TP, n1 - t0);
    if (narrow) {
      __syncthreads();  // the sub-tile before is read
      for (int i = tid; i < TP * REC; i += blockDim.x) {
        T val = T(0);
        if (i < TP * D) {
          const int t = i / D;
          if (t < tp) val = x[static_cast<size_t>(t0) * D + i];
        } else if (i < TP * (D + MT)) {
          const int t = (i - TP * D) / MT, o = (i - TP * D) % MT;
          if (g0 != nullptr && t < tp && o0 + o < m) val = g0[static_cast<size_t>(t0 + t) * m + o0 + o];
        } else {
          const int r = i - TP * (D + MT), s = r / (TP * MT), t = (r / MT) % TP, o = r % MT;
          const T* g = s < D ? g1 : g2;
          const int k = s < D ? s : s - D;
          if (g != nullptr && t < tp && o0 + o < m) val = g[(static_cast<size_t>(k) * n + t0 + t) * m + o0 + o];
        }
        st[i] = val;
      }
      __syncthreads();
      if (lead) {
        for (int t = tid; t < tp; t += blockDim.x) {
#pragma unroll
          for (int o = 0; o < MT; ++o) ab2[o] += st[TP * D + t * MT + o];
        }
      }
      for (int t = 0; t < tp; ++t) {
        const StagedPoint<T, D, MT, TP> p{st, t};
        const T dz = point_bwd<T, D, ORDER, MT>(p, bj, w, ww, w2x, v, actv, aw1, ab1, aw2);
        if constexpr (PGRAD) {
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const T s = warp_sum(w[k] * dz);
            if (lane == 0) red[warp][t * D + k] = s;
          }
        }
      }
    } else if constexpr (D == kMaxDims) {
      const size_t dstride = static_cast<size_t>(n) * m;
      if (lead && g0 != nullptr) {
        for (int t = tid; t < tp; t += blockDim.x) {
#pragma unroll
          for (int o = 0; o < MT; ++o) {
            if (o0 + o < m) ab2[o] += g0[static_cast<size_t>(t0 + t) * m + o0 + o];
          }
        }
      }
      for (int t = 0; t < tp; ++t) {
        const size_t row = static_cast<size_t>(t0 + t) * m + o0;
        const GlobalPoint<T, D, MT> p{x + static_cast<size_t>(t0 + t) * d, wrow,
                                      g0 == nullptr ? nullptr : g0 + row, g1 == nullptr ? nullptr : g1 + row,
                                      g2 == nullptr ? nullptr : g2 + row, dstride, d, dir0, m - o0};
        const T dz = point_bwd<T, D, ORDER, MT>(p, bj, w, ww, w2x, v, actv, aw1, ab1, aw2);
        if constexpr (PGRAD) {
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const T s = warp_sum(w[k] * dz);
            if (lane == 0) red[warp][t * D + k] = s;
          }
        }
      }
    }
    if constexpr (PGRAD) {  // the sub-tile's points' gradient: this block's units, in warp order
      __syncthreads();
      T* slab = gxp + static_cast<size_t>(blockIdx.y) * n * d;
      for (int i = tid; i < tp * D; i += blockDim.x) {
        const int t = i / D, k = i % D;
        if (dir0 + k < own0) continue;
        T s = red[0][i];
        for (int q = 1; q < nwarps; ++q) s += red[q][i];
        slab[static_cast<size_t>(t0 + t) * d + dir0 + k] = s;
      }
      __syncthreads();  // red is read before the next sub-tile writes it
    }
  }

  const int out_tiles = (m + MT - 1) / MT;
  const size_t hd = static_cast<size_t>(h) * d;
  T* slab = part + (static_cast<size_t>(blockIdx.x) * out_tiles + ot) * (hd + h + static_cast<size_t>(MT) * h + MT);
  if (j < h) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (dir0 + k >= own0) slab[static_cast<size_t>(j) * d + dir0 + k] = aw1[k];
    }
    if (c == 0) {
      slab[hd + j] = ab1;
#pragma unroll
      for (int o = 0; o < MT; ++o) {
        if (o0 + o < m) slab[hd + h + static_cast<size_t>(o) * h + j] = aw2[o];
      }
    }
  }
  if (lead) {  // the tile's db2 over the block's threads: warp sums, then the warps in order
#pragma unroll
    for (int o = 0; o < MT; ++o) {
      const T s = warp_sum(ab2[o]);
      if (lane == 0) red[warp][o] = s;
    }
    __syncthreads();
    if (tid < MT && o0 + tid < m) {
      T s = red[0][tid];
      for (int q = 1; q < nwarps; ++q) s += red[q][tid];
      slab[hd + h + static_cast<size_t>(MT) * h + tid] = s;
    }
  }
}

// The sum pass: out = [dW1 (h, d) | db1 (h) | dW2 (m, h) | db2 (m)] summed
// over the slabs of `part` that hold it (dW1 and db1: every (point block,
// output tile) slab; an output's dW2 row and db2: its tile's slab of each
// point block), then gx (n, d) over the `gx_slabs` slabs of gxp. A block of 32 x
// kSumLanes threads takes 32 consecutive elements: lane y sums slabs y, y +
// kSumLanes, ... in order, then the lanes add as a fixed tree.
template <typename T>
__global__ void __launch_bounds__(32 * kSumLanes)
taylor_mlp_1h_bwd_sum_kernel(const T* __restrict__ part, const T* __restrict__ gxp, int blocks, int n, int d,
                             int h, int m, int mt, int gx_slabs, T* __restrict__ out, T* __restrict__ gx) {
  __shared__ T sums[kSumLanes][32];
  const size_t hd = static_cast<size_t>(h) * d, w2 = static_cast<size_t>(m) * h, g = hd + h + w2 + m;
  const size_t slab = hd + h + static_cast<size_t>(mt) * h + mt;  // one slab of part
  const size_t total = g + (gx != nullptr ? static_cast<size_t>(n) * d : 0);
  const size_t e = static_cast<size_t>(blockIdx.x) * 32 + threadIdx.x;
  const int out_tiles = (m + mt - 1) / mt;
  const T* base = nullptr;
  size_t stride = 0;
  int count = 0;
  if (e < hd + h) {
    base = part + e, stride = slab, count = blocks * out_tiles;
  } else if (e < hd + h + w2) {  // dW2[o, j]: row o % mt of tile o / mt
    const size_t o = (e - hd - h) / h, j = (e - hd - h) % h;
    base = part + (o / mt) * slab + hd + h + (o % mt) * h + j, stride = out_tiles * slab, count = blocks;
  } else if (e < g) {
    const size_t o = e - hd - h - w2;
    base = part + (o / mt) * slab + hd + h + static_cast<size_t>(mt) * h + o % mt;
    stride = out_tiles * slab, count = blocks;
  } else if (e < total) {
    base = gxp + (e - g), stride = static_cast<size_t>(n) * d, count = gx_slabs;
  }
  T s = T(0);
  for (int q = threadIdx.y; q < count; q += kSumLanes) s += base[q * stride];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int off = kSumLanes / 2; off > 0; off >>= 1) {
    if (threadIdx.y < off) sums[threadIdx.y][threadIdx.x] += sums[threadIdx.y + off][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.y == 0 && e < total) {
    if (e < g) {
      out[e] = sums[0][threadIdx.x];
    } else {
      gx[e - g] = sums[0][threadIdx.x];
    }
  }
}

// ---------------------------------------------------------------- host side
bool bad_block(int threads) { return threads < 32 || threads > kMaxThreads || threads % 32 != 0; }

template <typename T, int D, int ORDER>
int launch_1h(const T* x, int n, int d, int h, int n_out, const T* W1, const T* b1, const T* W2,
              const T* b2, int actv, int tile, int threads, T* c0, T* c1, T* c2,
              cudaStream_t stream) {
  if (tile < 1 || tile > max_tile_1h(1 + ORDER * D) || n_out < 1 || n_out > kMaxGridYZ || h < 1) {
    return kInvalid;
  }
  const dim3 grid((n + tile - 1) / tile, n_out, chunks_of(d));
  if (actv == kActTanh) {
    taylor_mlp_1h_kernel<T, D, ORDER, kActTanh><<<grid, threads, 0, stream>>>(
        x, n, d, h, n_out, W1, b1, W2, b2, tile, c0, c1, c2);
  } else {
    taylor_mlp_1h_kernel<T, D, ORDER, kActSin><<<grid, threads, 0, stream>>>(
        x, n, d, h, n_out, W1, b1, W2, b2, tile, c0, c1, c2);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int ORDER, bool STREAMS>
int launch_general(const T* x, int n, int d, int n_layers, const MLPParams<T>& p, int actv, int in_actv,
                   int tile, int threads, int smem, int hstride, int blocks, T* gbuf, T* c0, T* c1, T* c2,
                   cudaStream_t stream) {
  constexpr int S = 1 + ORDER * D;
  if ((STREAMS || n_layers != 1) && tile != (threads / 32) * points_per_warp(S)) return kInvalid;
  if (smem < 0 || smem > kSmemLimit || blocks < 1) return kInvalid;
  // raise the kernel's dynamic shared-memory ceiling once per device, to the limit
  static bool ceiling_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kInvalid;
  if (!ceiling_set[dev]) {
    err = cudaFuncSetAttribute(taylor_mlp_kernel<T, D, ORDER, false, STREAMS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    ceiling_set[dev] = true;
  }
  const dim3 grid(blocks, chunks_of(d));
  if (gbuf == nullptr) {
    taylor_mlp_kernel<T, D, ORDER, false, STREAMS><<<grid, threads, smem, stream>>>(
        x, n, d, n_layers, p, actv, in_actv, tile, hstride, nullptr, c0, c1, c2);
  } else {  // the scratch variant needs only the weight tiles' shared memory, under the default ceiling
    taylor_mlp_kernel<T, D, ORDER, true, STREAMS><<<grid, threads, smem, stream>>>(
        x, n, d, n_layers, p, actv, in_actv, tile, hstride, gbuf, c0, c1, c2);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
struct OneHidden {
  template <int D, int ORDER>
  struct At {
    static int run(const void* x, int n, int d, int h, int n_out, const void* W1, const void* b1,
                   const void* W2, const void* b2, int actv, int tile, int threads, void* c0,
                   void* c1, void* c2, void* stream) {
      return launch_1h<T, D, ORDER>(
          static_cast<const T*>(x), n, d, h, n_out, static_cast<const T*>(W1),
          static_cast<const T*>(b1), static_cast<const T*>(W2), static_cast<const T*>(b2), actv,
          tile, threads, static_cast<T*>(c0), static_cast<T*>(c1), static_cast<T*>(c2),
          static_cast<cudaStream_t>(stream));
    }
  };
};

template <typename T, bool STREAMS>
struct General {
  template <int D, int ORDER>
  struct At {
    static int run(const void* x, int n, int d, int n_layers, const MLPParams<T>* p, int actv,
                   int in_actv, int tile, int threads, int smem, int hstride, int blocks, void* scratch,
                   void* c0, void* c1, void* c2, void* stream) {
      return launch_general<T, D, ORDER, STREAMS>(static_cast<const T*>(x), n, d, n_layers, *p, actv,
                                                  in_actv, tile, threads, smem, hstride, blocks,
                                                  static_cast<T*>(scratch), static_cast<T*>(c0),
                                                  static_cast<T*>(c1), static_cast<T*>(c2),
                                                  static_cast<cudaStream_t>(stream));
    }
  };
};

template <typename T>
int forward_1h(const void* x, int n, int d, int h, int n_out, const void* W1, const void* b1,
               const void* W2, const void* b2, int order, int actv, int tile, int threads,
               void* c0, void* c1, void* c2, void* stream) {
  if (bad_block(threads) || n < 1) return kInvalid;
  return dispatch<OneHidden<T>::template At>(d, order, x, n, d, h, n_out, W1, b1, W2, b2, actv,
                                             tile, threads, c0, c1, c2, stream);
}

// The backward's arguments (the C entry's, typed).
template <typename T>
struct BwdArgs {
  const T *x, *W1, *b1, *W2, *g0, *g1, *g2;
  int n, d, h, m, actv, mt, threads, blocks, span;
  bool pgrad;
  T *part, *gxp, *out, *gx;
  cudaStream_t stream;
};

template <typename T, int D, int ORDER, int MT, bool PGRAD>
void launch_1h_bwd_main(const BwdArgs<T>& a, dim3 grid) {
  taylor_mlp_1h_bwd_kernel<T, D, ORDER, MT, PGRAD><<<grid, a.threads, 0, a.stream>>>(
      a.x, a.n, a.d, a.h, a.m, a.W1, a.b1, a.W2, a.actv, a.span, a.g0, a.g1, a.g2, a.part, a.gxp);
}

template <typename T>
struct BackwardHidden {
  template <int D, int ORDER>
  struct At {
    static int run(const BwdArgs<T>& a) {
      const int unit_tiles = (a.h + a.threads - 1) / a.threads, out_tiles = (a.m + a.mt - 1) / a.mt;
      if (static_cast<long long>(unit_tiles) * out_tiles > kMaxGridYZ) return kInvalid;
      const dim3 grid(a.blocks, unit_tiles * out_tiles, chunks_of(a.d));
#define NDTORCH_BWD(MT)                                                          \
  if (a.mt == MT) {                                                              \
    if (a.pgrad) {                                                               \
      launch_1h_bwd_main<T, D, ORDER, MT, true>(a, grid);                        \
    } else {                                                                     \
      launch_1h_bwd_main<T, D, ORDER, MT, false>(a, grid);                       \
    }                                                                            \
  }
      NDTORCH_BWD(1) else NDTORCH_BWD(4) else NDTORCH_BWD(16) else return kInvalid;
#undef NDTORCH_BWD
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      const size_t total = (static_cast<size_t>(a.h) * a.d + a.h + static_cast<size_t>(a.m) * a.h + a.m) +
                           (a.pgrad ? static_cast<size_t>(a.n) * a.d : 0);
      const size_t sum_blocks = (total + 31) / 32;
      if (sum_blocks > 0x7fffffffu) return kInvalid;
      taylor_mlp_1h_bwd_sum_kernel<T><<<static_cast<unsigned>(sum_blocks), dim3(32, kSumLanes), 0, a.stream>>>(
          a.part, a.gxp, a.blocks, a.n, a.d, a.h, a.m, a.mt, unit_tiles * out_tiles, a.out,
          a.pgrad ? a.gx : nullptr);
      return static_cast<int>(cudaGetLastError());
    }
  };
};

template <typename T>
int backward_1h(const void* x, int n, int d, int h, int m, const void* W1, const void* b1, const void* W2,
                int order, int actv, int mt, int threads, int blocks, int span, int pgrad, const void* g0,
                const void* g1, const void* g2, void* part, void* gxp, void* out, void* gx, void* stream) {
  if (threads < 32 || threads > kBwdThreads || threads % 32 != 0 || n < 1 || h < 1 || m < 1 ||
      (actv != kActTanh && actv != kActSin) || blocks < 1 || span < 1 ||
      static_cast<long long>(blocks - 1) * span >= n || static_cast<long long>(blocks) * span < n ||
      part == nullptr || out == nullptr || (pgrad && (gxp == nullptr || gx == nullptr))) {
    return kInvalid;
  }
  const BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(W1), static_cast<const T*>(b1),
                     static_cast<const T*>(W2), static_cast<const T*>(g0), static_cast<const T*>(g1),
                     static_cast<const T*>(g2), n, d, h, m, actv, mt, threads, blocks, span, pgrad != 0,
                     static_cast<T*>(part), static_cast<T*>(gxp), static_cast<T*>(out), static_cast<T*>(gx),
                     static_cast<cudaStream_t>(stream)};
  return dispatch<BackwardHidden<T>::template At>(d, order, a);
}

// STREAMS: x is (1 + order d, n, dims[0]) input streams, in_actv their
// activation; every width but the output's is staged, so each is at most
// hstride. Otherwise x is (n, d) points, dims[0] == d and in_actv unused.
template <typename T, bool STREAMS>
int forward_general(const void* x, int n, int d, int n_layers, const int* dims,
                    const void* const* W, const void* const* b, int order, int actv, int in_actv,
                    int tile, int threads, int smem, int hstride, int blocks, void* scratch, void* c0,
                    void* c1, void* c2, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || bad_block(threads) || tile < 1 || n < 1 ||
      (!STREAMS && dims[0] != d) || (STREAMS && in_actv != kActNone && in_actv != kActTanh &&
                                     in_actv != kActSin)) {
    return kInvalid;
  }
  MLPParams<T> p;
  for (int l = 0; l < n_layers; ++l) {
    p.W[l] = static_cast<const T*>(W[l]);
    p.b[l] = static_cast<const T*>(b[l]);
  }
  for (int l = 0; l <= n_layers; ++l) {
    p.dims[l] = dims[l];
    if ((STREAMS || l > 0) && l < n_layers && (dims[l] > hstride || dims[l] < 1)) return kInvalid;
  }
  return dispatch<General<T, STREAMS>::template At>(d, order, x, n, d, n_layers, &p, actv, in_actv, tile,
                                                    threads, smem, hstride, blocks, scratch, c0, c1, c2,
                                                    stream);
}

}  // namespace

extern "C" {

// Every function launches on `stream` and returns cudaGetLastError() (0 on
// success) or cudaErrorInvalidValue for arguments the kernels do not take.
// Pointers are device pointers except `dims`, `W` and `b` of the general
// kernel, which are host arrays of n_layers + 1 ints and n_layers device
// pointers. Weights are in nn.Linear's (n_out, n_in) row-major layout. The
// general kernel runs `blocks` blocks per direction chunk; `scratch` is null
// (streams in shared memory) or holds 2 * (1 + order * min(d, 8)) * tile *
// hstride elements for each of them.
//
// taylor_mlp_streams_staged takes input streams x of (1 + order * d, n,
// dims[0]) elements and in_actv (-1: none, 0: tanh, 1: sin); its `blocks`,
// `scratch` and `hstride` are the general kernel's, hstride covering dims[0]
// too.
//
// taylor_mlp_1h_bwd is the gradient of taylor_mlp_1h for n points through
// d-h-m widths: g0 (n, m), g1 and g2 (d, n, m) are the cotangents of c0, c1
// and c2 (null where absent; g2 unused at order 1). It writes out = [dW1 (h,
// d) | db1 (h) | dW2 (m, h) | db2 (m)] (nn.Linear layouts) and, with pgrad,
// gx (n, d). `part` holds blocks * ceil(m / mt) slabs of h d + h + mt h + mt
// elements, `gxp`
// (pgrad) ceil(h / threads) * ceil(m / mt) slabs of n * d; the blocks own
// `span` points each and together exactly cover n.
//
// The build compiles this file once per entry point, all at once, with
// -DNDTORCH_ENTRY=1..8 (the order below), beside the other sources' entries,
// and links the objects; with no NDTORCH_ENTRY one compile holds them all.
#ifndef NDTORCH_ENTRY
#define NDTORCH_ENTRY 0
#endif

#if NDTORCH_ENTRY == 0 || NDTORCH_ENTRY == 1
int taylor_mlp_1h_f32(const void* x, int n, int d, int h, int n_out, const void* W1,
                      const void* b1, const void* W2, const void* b2, int order, int actv,
                      int tile, int threads, void* c0, void* c1, void* c2, void* stream) {
  return forward_1h<float>(x, n, d, h, n_out, W1, b1, W2, b2, order, actv, tile, threads, c0, c1,
                           c2, stream);
}
#endif

#if NDTORCH_ENTRY == 0 || NDTORCH_ENTRY == 2
int taylor_mlp_1h_f64(const void* x, int n, int d, int h, int n_out, const void* W1,
                      const void* b1, const void* W2, const void* b2, int order, int actv,
                      int tile, int threads, void* c0, void* c1, void* c2, void* stream) {
  return forward_1h<double>(x, n, d, h, n_out, W1, b1, W2, b2, order, actv, tile, threads, c0, c1,
                            c2, stream);
}
#endif

#if NDTORCH_ENTRY == 0 || NDTORCH_ENTRY == 3
int taylor_mlp_f32(const void* x, int n, int d, int n_layers, const int* dims,
                   const void* const* W, const void* const* b, int order, int actv, int tile,
                   int threads, int smem, int hstride, int blocks, void* scratch, void* c0,
                   void* c1, void* c2, void* stream) {
  return forward_general<float, false>(x, n, d, n_layers, dims, W, b, order, actv, 0, tile, threads,
                                       smem, hstride, blocks, scratch, c0, c1, c2, stream);
}
#endif

#if NDTORCH_ENTRY == 0 || NDTORCH_ENTRY == 4
int taylor_mlp_f64(const void* x, int n, int d, int n_layers, const int* dims,
                   const void* const* W, const void* const* b, int order, int actv, int tile,
                   int threads, int smem, int hstride, int blocks, void* scratch, void* c0,
                   void* c1, void* c2, void* stream) {
  return forward_general<double, false>(x, n, d, n_layers, dims, W, b, order, actv, 0, tile, threads,
                                        smem, hstride, blocks, scratch, c0, c1, c2, stream);
}
#endif

#if NDTORCH_ENTRY == 0 || NDTORCH_ENTRY == 5
int taylor_mlp_streams_staged_f32(const void* x, int n, int d, int n_layers, const int* dims,
                                  const void* const* W, const void* const* b, int order, int actv, int in_actv,
                                  int tile, int threads, int smem, int hstride, int blocks, void* scratch,
                                  void* c0, void* c1, void* c2, void* stream) {
  return forward_general<float, true>(x, n, d, n_layers, dims, W, b, order, actv, in_actv, tile, threads,
                                      smem, hstride, blocks, scratch, c0, c1, c2, stream);
}
#endif

#if NDTORCH_ENTRY == 0 || NDTORCH_ENTRY == 6
int taylor_mlp_streams_staged_f64(const void* x, int n, int d, int n_layers, const int* dims,
                                  const void* const* W, const void* const* b, int order, int actv, int in_actv,
                                  int tile, int threads, int smem, int hstride, int blocks, void* scratch,
                                  void* c0, void* c1, void* c2, void* stream) {
  return forward_general<double, true>(x, n, d, n_layers, dims, W, b, order, actv, in_actv, tile, threads,
                                       smem, hstride, blocks, scratch, c0, c1, c2, stream);
}
#endif

#if NDTORCH_ENTRY == 0 || NDTORCH_ENTRY == 7
int taylor_mlp_1h_bwd_f32(const void* x, int n, int d, int h, int m, const void* W1, const void* b1,
                          const void* W2, int order, int actv, int mt, int threads, int blocks, int span,
                          int pgrad, const void* g0, const void* g1, const void* g2, void* part, void* gxp,
                          void* out, void* gx, void* stream) {
  return backward_1h<float>(x, n, d, h, m, W1, b1, W2, order, actv, mt, threads, blocks, span, pgrad, g0, g1,
                            g2, part, gxp, out, gx, stream);
}
#endif

#if NDTORCH_ENTRY == 0 || NDTORCH_ENTRY == 8
int taylor_mlp_1h_bwd_f64(const void* x, int n, int d, int h, int m, const void* W1, const void* b1,
                          const void* W2, int order, int actv, int mt, int threads, int blocks, int span,
                          int pgrad, const void* g0, const void* g1, const void* g2, void* part, void* gxp,
                          void* out, void* gx, void* stream) {
  return backward_1h<double>(x, n, d, h, m, W1, b1, W2, order, actv, mt, threads, blocks, span, pgrad, g0, g1,
                             g2, part, gxp, out, gx, stream);
}
#endif

}  // extern "C"
