// taylor_mlp_streams: the fused Taylor-mode FCNN forward on input Taylor
// streams, for Hopper (sm_90a).
//
// What it computes. The input is (1 + order d, N, h_in) streams, the layout
// the kernels write: the value, the d first-order and (order 2) the d
// second-order coefficients. An optional input activation is applied with
// the chain rule, then 1-kMaxLayers affine layers with tanh or sin between
// them; the output is the (1 + order d, N, n_out) stack. The math is the
// plain twin neurodiffeq_tpu_torch/ops/taylor_mlp.py::
// fcnn_taylor_streams_reference: every stream goes through the same W_l (the
// bias only into the value), and between layers a = f(z0), u1 = f' z1,
// u2 = f' z2 + f'' z1^2.
//
// Why it exists. A layer pair of a net split over the ranks of a 'model'
// mesh axis (Megatron tensor parallelism) starts from the summed streams of
// the pair before, not from raw coordinates. On the TPU that axis ran the
// plain Taylor path (Pallas is off by default there): this kernel replaces
// no Pallas kernel, and exists so that no layer pair of a split net runs as
// plain PyTorch on the card.
//
// What bounds it. Every stream of a point tile goes through the same W_l,
// so a layer is one matrix product (S tile rows, h_in) x (h_in, h_out) over
// the S = 1 + order D stacked streams. On tensor cores the products are
// cheaper than moving the streams: one model rank's slice of the cavity's
// pair 1 (128 -> 64 -> 128, S = 5, N = 16,384) moves 84.0 MB (25.1 us at
// 3.35 TB/s) for 2.68 GFLOP of products (16.3 us at 165 TFLOP/s, 3xTF32);
// its pair 2 (128 -> 64 -> 3) moves 42.9 MB (12.8 us) for 1.37 GFLOP
// (8.3 us). Both are bound by bytes.
//
// The design.
// - Tensor cores. float32 runs mma.sync.m16n8k8 TF32 in the 3xTF32 split
//   (hi = rna(a), lo = rna(a - hi), with rna cvt.rna.tf32.f32's rounding
//   done in two integer operations; a_lo b_hi, a_hi b_lo and a_hi b_hi
//   each into its own accumulator, so that three chains of dependent mma
//   run side by side, summed at the end), which keeps float32 well inside
//   1e-4 of the full-precision twin; float64 runs DMMA (mma.sync.m8n8k4
//   f64). A warp takes (one m tile of rows) x (two n tiles of 8 units)
//   items of a layer, round robin over the block's 16 warps.
// - The output layer is a product like every other. Narrow outputs are
//   padded to the n tile with zero weight rows; the epilogue adds the bias
//   to the value stream, stages the tile in shared memory, and each
//   stream's tile x n_out outputs, contiguous in the output stack, leave in
//   16-byte coalesced stores.
// - The chain rule runs from shared memory: a layer's epilogue writes its
//   pre-activations to a shared buffer, and after a barrier each thread
//   takes (point, unit) pairs through the activation over their S streams,
//   in place.
// - Resident weights. Blocks are persistent (one of 512 threads on each
//   SM) and walk the (point tile, direction chunk) units; each copies every
//   layer's weights into shared memory once, by cp.async, rows padded so
//   that the fragment loads are free of bank conflicts (a row stride of 4
//   mod 8 elements).
// - Bulk copies. A unit's S stream slabs, each tile x h_in contiguous
//   elements of the input, arrive as S bulk copies (cp.async.bulk, the
//   copy engine) on an mbarrier into a raw double buffer: the next unit's
//   copies fly while this one computes, and they take none of the load
//   units the products' fragment loads use. One pass then builds the first
//   layer's operand from the raw slabs: the input activation with the
//   chain rule, into padded rows. Where a point's row is not a multiple of
//   16 bytes (or the input not 16-byte aligned) each element comes by
//   cp.async, tracked by the same mbarrier. Where two raw buffers do not
//   fit, one: the next unit's copies start once the operand is built.
// Shapes whose weights cannot stay resident (2800 -> 64 -> 1: 717 KB; in
// float64 the cavity's 128 -> 64 -> 128 pair) go to
// taylor_mlp_streams_staged (taylor_mlp.cu), and so do narrow nets (an
// output under 8 units, an input at most 64 wide, at most 2,048
// multiply-adds per point and stream: the default FCNN's trailing 32 -> 1
// layer), where that instance is the faster: there this kernel's fixed
// latency per tile is not hidden. ops/taylor_mlp.py::_plan_streams routes
// by shape and mirrors the layout below.
//
// NaNs. The float32 products round by integer arithmetic (Mma<float>::rna),
// which would turn the card's own NaN into -0; every operand written to
// shared memory holds its NaNs as the quiet NaN 0x7fc00000 (keep_nan),
// which the rounding keeps, so a NaN comes out where the twin's does.
//
// Sums run in a fixed order without atomics: two launches give bitwise-
// equal outputs.
#include "taylor_mlp_common.cuh"

namespace {

constexpr int kThreads = 512;  // threads of a block: one block on an SM
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 2;               // n tiles of 8 units in one warp item
constexpr int kRowTile = 8 * kNB;    // weight rows are padded to a multiple of this
constexpr int kBarBytes = 16;        // two mbarriers at the start of shared memory

// Rows of an m tile, depth of a k step, and points of a unit's tile (a
// multiple of the m tile, so that S x tile rows fill whole m tiles).
template <typename T>
struct Tiles;
template <>
struct Tiles<float> {
  static constexpr int kM = 16, kK = 8, kTile = 16;
};
template <>
struct Tiles<double> {
  static constexpr int kM = 8, kK = 4, kTile = 8;
};

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Row stride in shared memory of a width-h operand: whole k steps, and 4
// mod 8 elements, so that the 8 rows x 4 columns a fragment load reads lie
// in distinct banks.
template <typename T>
__host__ __device__ constexpr int hstride(int h) {
  const int k = round_up(h, Tiles<T>::kK);
  return k % 8 == 4 ? k : k + 4;
}

// Shared-memory layout, in elements after the mbarriers: every layer's
// weights (rows padded to kRowTile, stride hstride of its input), then its
// bias (padded to a multiple of 4),
// `buffers` raw input buffers (a unit's S stream slabs of tile x dims[0],
// as the input holds them), the first layer's operand (rows of stride
// hstride(dims[0])), min(2, n_layers - 1) buffers of hidden streams, and
// the output stage, which is the operand buffer where the outputs fit
// there and the operand is not the output layer's.
struct Layout {
  int bias, raw, raw_elems, in, hid, hid_elems, hid_stride, stage;
  bool stage_in_operand;
  size_t bytes;
};

template <typename T>
__host__ __device__ Layout layout(const int* dims, int n_layers, int s, int buffers) {
  constexpr int tp = Tiles<T>::kTile;
  Layout L{};
  int e = 0;
  for (int l = 0; l < n_layers; ++l) e += round_up(dims[l + 1], kRowTile) * hstride<T>(dims[l]);
  L.bias = e;
  for (int l = 0; l < n_layers; ++l) e += round_up(dims[l + 1], 4);
  L.raw = e;
  L.raw_elems = s * tp * dims[0];
  e += buffers * L.raw_elems;
  L.in = e;
  e += s * tp * hstride<T>(dims[0]);
  L.hid = e;
  L.hid_stride = 0;
  for (int l = 1; l < n_layers; ++l) {
    const int hs = hstride<T>(dims[l]);
    if (hs > L.hid_stride) L.hid_stride = hs;
  }
  L.hid_elems = s * tp * L.hid_stride;
  e += (n_layers > 2 ? 2 : n_layers - 1) * L.hid_elems;
  L.stage = e;
  L.stage_in_operand = n_layers >= 2 && dims[n_layers] <= hstride<T>(dims[0]);
  if (!L.stage_in_operand) e += s * tp * dims[n_layers];
  L.bytes = kBarBytes + static_cast<size_t>(e) * sizeof(T);
  return L;
}

// ---------------------------------------------------------------- tensor-core fragments
// mma.sync fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8" and
// "mma.m8n8k4"): g = lane / 4, q = lane % 4. A is row-major in shared
// memory at the tile's first row and the step's first column; B is read
// from the weights' (unit, input) rows, W[n][k], at the tile's first unit.
template <typename T>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int kAcc = 4, kParts = 3;  // 3xTF32: three products, each its own accumulator
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  // cvt.rna.tf32.f32 of x, in two integer operations where the instruction
  // takes four: the same rounding for finite values and infinities, and a
  // NaN stays one where its mantissa's top bits are not all set, as in the
  // quiet NaN 0x7fc00000 (the card's own NaN, 0x7fffffff, would carry into
  // the sign bit: -0). Every operand in shared memory holds its NaNs in
  // that form (keep_nan), so no test for them runs in the product loops.
  static __device__ __forceinline__ uint32_t rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }
  static __device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = rna(x);
    lo = rna(x - __uint_as_float(hi));
  }
  static __device__ __forceinline__ A load_a(const float* p, int stride, int lane) {
    const int g = lane >> 2, q = lane & 3;
    A a;
    split(p[g * stride + q], a.hi[0], a.lo[0]);
    split(p[(g + 8) * stride + q], a.hi[1], a.lo[1]);
    split(p[g * stride + q + 4], a.hi[2], a.lo[2]);
    split(p[(g + 8) * stride + q + 4], a.hi[3], a.lo[3]);
    return a;
  }
  static __device__ __forceinline__ B load_b(const float* w, int stride, int lane) {
    const int g = lane >> 2, q = lane & 3;
    B b;
    split(w[g * stride + q], b.hi[0], b.lo[0]);
    split(w[g * stride + q + 4], b.hi[1], b.lo[1]);
    return b;
  }
  static __device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // a_lo b_hi, a_hi b_lo and a_hi b_hi into three accumulators: three chains of dependent mma, not one
  static __device__ __forceinline__ void mac(float (&acc)[3][4], const A& a, const B& b) {
    mma(acc[0], a.lo, b.hi);
    mma(acc[1], a.hi, b.lo);
    mma(acc[2], a.hi, b.hi);
  }
  static __device__ __forceinline__ float sum(const float (&acc)[3][4], int e) { return (acc[0][e] + acc[1][e]) + acc[2][e]; }
  // row and column in the 16 x 8 tile of accumulator e of the lane
  static __device__ __forceinline__ int row(int e, int lane) { return (lane >> 2) + (e & 2) * 4; }
  static __device__ __forceinline__ int col(int e, int lane) { return 2 * (lane & 3) + (e & 1); }
};

template <>
struct Mma<double> {
  static constexpr int kAcc = 2, kParts = 1;
  struct A { double v; };
  struct B { double v; };

  static __device__ __forceinline__ A load_a(const double* p, int stride, int lane) {
    return A{p[(lane >> 2) * stride + (lane & 3)]};
  }
  static __device__ __forceinline__ B load_b(const double* w, int stride, int lane) {
    return B{w[(lane >> 2) * stride + (lane & 3)]};
  }
  static __device__ __forceinline__ void mac(double (&acc)[1][2], const A& a, const B& b) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
                 : "+d"(acc[0][0]), "+d"(acc[0][1])
                 : "d"(a.v), "d"(b.v));
  }
  static __device__ __forceinline__ double sum(const double (&acc)[1][2], int e) { return acc[0][e]; }
  static __device__ __forceinline__ int row(int, int lane) { return lane >> 2; }
  static __device__ __forceinline__ int col(int e, int lane) { return 2 * (lane & 3) + e; }
};

// A value as an operand of the products stores it in shared memory: a
// float NaN as the quiet NaN 0x7fc00000, which Mma<float>::rna keeps a NaN
// (so a NaN in the streams or the weights comes out a NaN, as in the twin);
// anything else as it is.
template <typename T>
__device__ __forceinline__ T keep_nan(T v) {
  if constexpr (sizeof(T) == 4) {
    if ((__float_as_uint(v) & 0x7fffffffu) > 0x7f800000u) return __uint_as_float(0x7fc00000u);
  }
  return v;
}

// epi(r, j, v) for every row r < ROWS and unit j < wrows of a (ROWS, kpad)
// x (kpad, wrows) product: `a` the operand rows (stride a_stride), `w` the
// layer's weights (wrows rows of stride w_stride).
template <typename T, int ROWS, typename Epi>
__device__ __forceinline__ void product(const T* a, int a_stride, const T* w, int w_stride, int kpad, int wrows,
                                        Epi epi) {
  using M = Mma<T>;
  constexpr int MT = ROWS / Tiles<T>::kM;
  static_assert(ROWS % Tiles<T>::kM == 0, "a unit's rows fill whole m tiles");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int items = MT * (wrows / kRowTile);
  for (int it = warp; it < items; it += kWarps) {
    const int m0 = (it % MT) * Tiles<T>::kM, j0 = (it / MT) * kRowTile;
    const T* ap = a + m0 * a_stride;
    const T* wp = w + j0 * w_stride;
    T acc[kNB][M::kParts][M::kAcc] = {};
#pragma unroll 4
    for (int k = 0; k < kpad; k += Tiles<T>::kK) {
      const typename M::A fa = M::load_a(ap + k, a_stride, lane);
#pragma unroll
      for (int u = 0; u < kNB; ++u) M::mac(acc[u], fa, M::load_b(wp + 8 * u * w_stride + k, w_stride, lane));
    }
#pragma unroll
    for (int u = 0; u < kNB; ++u) {
#pragma unroll
      for (int e = 0; e < M::kAcc; ++e) epi(m0 + M::row(e, lane), j0 + 8 * u + M::col(e, lane), M::sum(acc[u], e));
    }
  }
}

// The activation with the chain rule on the S streams of one (point,
// unit): a = f(z0), u1 = f' z1, u2 = f' z2 + f'' z1^2.
template <typename T, int D, int ORDER>
__device__ __forceinline__ void chain(T (&v)[1 + ORDER * D], int actv) {
  T a, f1, f2;
  actv_chain(v[0], actv, a, f1, f2);
  v[0] = a;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const T z1 = v[1 + k];
    v[1 + k] = f1 * z1;
    if constexpr (ORDER == 2) v[1 + D + k] = f1 * v[1 + D + k] + f2 * z1 * z1;
  }
}

// The chain rule in place on a middle layer's pre-activations: the S
// streams of the tile's points (rows s * TP + t, stride hs), units j < h.
template <typename T, int D, int ORDER>
__device__ __forceinline__ void chain_rule(T* buf, int hs, int h, int actv) {
  constexpr int S = 1 + ORDER * D, TP = Tiles<T>::kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < TP; t += kWarps) {
    for (int j = lane; j < h; j += 32) {
      T v[S];
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = buf[(s * TP + t) * hs + j];
      chain<T, D, ORDER>(v, actv);
#pragma unroll
      for (int s = 0; s < S; ++s) buf[(s * TP + t) * hs + j] = keep_nan(v[s]);
    }
  }
}

// The first layer's operand from a unit's raw input (stream s of point t
// at raw[(s * TP + t) * h + j]): through the input activation (kActNone:
// as it is) into rows of stride hs, zero past the unit's `valid` points
// and in the padding up to kp.
template <typename T, int D, int ORDER>
__device__ __forceinline__ void load_operand(T* a, int hs, int kp, const T* raw, int h, int valid, int in_actv) {
  constexpr int S = 1 + ORDER * D, TP = Tiles<T>::kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < TP; t += kWarps) {
    for (int j = lane; j < kp; j += 32) {
      T v[S];
      const bool in = t < valid && j < h;
#pragma unroll
      for (int s = 0; s < S; ++s) v[s] = in ? raw[(s * TP + t) * h + j] : T(0);
      if (in && in_actv != kActNone) chain<T, D, ORDER>(v, in_actv);
#pragma unroll
      for (int s = 0; s < S; ++s) a[(s * TP + t) * hs + j] = keep_nan(v[s]);
    }
  }
}

// Stream s of a direction chunk starting at dir0, in the (1 + order d, n, .)
// input or output stack.
template <int D>
__device__ __forceinline__ int global_stream(int s, int d, int dir0) {
  return s == 0 ? 0 : (s <= D ? dir0 + s : d + dir0 + s - D);
}

// ---------------------------------------------------------------- asynchronous copies
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// the executing thread's arrival, once its earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory by the bulk copy engine, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// Starts the copy of the unit at point n0 and direction chunk dir0 into the
// raw buffer `raw`: its S stream slabs, each `valid` x h contiguous elements
// of the input, as S bulk copies where `bulk` (h elements a whole number of
// 16 bytes, x 16-byte aligned), else element by element by cp.async. Every
// thread arrives on `bar` once; the phase completes when the bytes land.
template <typename T, int D, int ORDER>
__device__ __forceinline__ void issue_unit(T* raw, uint64_t* bar, const T* x, int n, int d, int h, int n0, int dir0,
                                           bool bulk) {
  constexpr int S = 1 + ORDER * D, TP = Tiles<T>::kTile;
  const int valid = min(TP, n - n0);
  if (bulk) {
    if (threadIdx.x == 0) {  // the bytes before the copies, so that the phase cannot end early
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the generic reads of this buffer
      mbar_arrive_expect_tx(bar, static_cast<unsigned>(S * valid * h * sizeof(T)));
#pragma unroll 1
      for (int s = 0; s < S; ++s) {
        bulk_copy(raw + s * TP * h, x + (static_cast<size_t>(global_stream<D>(s, d, dir0)) * n + n0) * h,
                  static_cast<unsigned>(valid * h * sizeof(T)), bar);
      }
    } else {
      mbar_arrive(bar);
    }
  } else {
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      const T* src = x + (static_cast<size_t>(global_stream<D>(s, d, dir0)) * n + n0) * h;
      for (int i = threadIdx.x; i < valid * h; i += kThreads) cp_async(raw + s * TP * h + i, src + i);
    }
    mbar_arrive_cp_async(bar);
  }
}

// Every layer's weights and biases into shared memory, once per block: W_l
// as (unit, input) rows of stride hstride(dims[l]), rows padded to
// kRowTile, zero outside the layer; the biases at `bs`, each padded to a
// multiple of 4.
template <typename T>
__device__ __forceinline__ void load_weights(T* ws, T* bs, const MLPParams<T>& p, int n_layers) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = 0; l < n_layers; ++l) {
    for (int j = threadIdx.x; j < p.dims[l + 1]; j += kThreads) cp_async(bs + j, p.b[l] + j);
    bs += round_up(p.dims[l + 1], 4);
  }
  for (int l = 0; l < n_layers; ++l) {
    const int hin = p.dims[l], hout = p.dims[l + 1], ks = hstride<T>(hin), rows = round_up(hout, kRowTile);
    for (int r = warp; r < rows; r += kWarps) {
      for (int c = lane; c < ks; c += 32) {
        T* dst = ws + r * ks + c;
        if (r < hout && c < hin) {
          cp_async(dst, p.W[l] + static_cast<size_t>(r) * hin + c);
        } else {
          *dst = T(0);
        }
      }
    }
    ws += rows * ks;
  }
}

// keep_nan on the weights this thread copied in load_weights, once its
// copies have landed (cp_async_wait): float products round them by rna.
template <typename T>
__device__ __forceinline__ void keep_weight_nans(T* ws, const MLPParams<T>& p, int n_layers) {
  if constexpr (sizeof(T) == 4) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int l = 0; l < n_layers; ++l) {
      const int hin = p.dims[l], hout = p.dims[l + 1], ks = hstride<T>(hin);
      for (int r = warp; r < hout; r += kWarps) {
        for (int c = lane; c < hin; c += 32) ws[r * ks + c] = keep_nan(ws[r * ks + c]);
      }
      ws += round_up(hout, kRowTile) * ks;
    }
  }
}

// A unit's S output streams from the stage (stream s at s * TP * n_out,
// dense) to the output stack: each stream's valid x n_out values are
// contiguous there, and leave in 16-byte stores where they are aligned.
template <typename T, int D, int ORDER>
__device__ __forceinline__ void store_unit(const T* stage, T* out, int n, int d, int dir0, int n_out, int n0,
                                           bool store_c0) {
  constexpr int S = 1 + ORDER * D, TP = Tiles<T>::kTile, V = 16 / sizeof(T);
  const int count = min(TP, n - n0) * n_out;
#pragma unroll 1
  for (int s = store_c0 ? 0 : 1; s < S; ++s) {
    const T* src = stage + s * TP * n_out;
    T* dst = out + (static_cast<size_t>(global_stream<D>(s, d, dir0)) * n + n0) * n_out;
    if (count % V == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
      for (int i = threadIdx.x; i < count / V; i += kThreads) {
        reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
      }
    } else {
      for (int i = threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
    }
  }
}

// ---------------------------------------------------------------- the kernel
// Grid: persistent blocks over the units u (point tile u % tiles, direction
// chunk u / tiles). x: the (1 + order d, n, dims[0]) input streams; out the
// (1 + order d, n, dims[n_layers]) output stack.
template <typename T, int D, int ORDER>
__global__ void __launch_bounds__(kThreads, 1)
taylor_mlp_streams_kernel(const T* __restrict__ x, int n, int d, int n_layers, MLPParams<T> p, int actv,
                          int in_actv, int buffers, int bulk, T* __restrict__ out) {
  constexpr int S = 1 + ORDER * D, TP = Tiles<T>::kTile, ROWS = S * TP;
  const int tiles = (n + TP - 1) / TP;
  const int units = tiles * (D == kMaxDims ? chunks_of(d) : 1);
  if (static_cast<int>(blockIdx.x) >= units) return;
  const Layout L = layout<T>(p.dims, n_layers, S, buffers);
  const int h0 = p.dims[0], hs0 = hstride<T>(h0), kp0 = round_up(h0, Tiles<T>::kK), n_out = p.dims[n_layers];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* const bar = reinterpret_cast<uint64_t*>(smem_raw);  // one per raw buffer
  T* const base = reinterpret_cast<T*>(smem_raw + kBarBytes);
  T* const raw0 = base + L.raw;  // raw buffer b at raw0 + b * L.raw_elems, hidden h at hid0 + h * L.hid_elems
  T* const in = base + L.in;
  T* const hid0 = base + L.hid;
  T* const stage = L.stage_in_operand ? in : base + L.stage;

  if (threadIdx.x == 0) {
    mbar_init(bar, kThreads);
    mbar_init(bar + 1, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_weights(base, base + L.bias, p, n_layers);
  cp_async_commit();
  __syncthreads();  // the barriers are set before any thread arrives
  issue_unit<T, D, ORDER>(raw0, bar, x, n, d, h0, (blockIdx.x % tiles) * TP, chunk_dir0<D>(d, blockIdx.x / tiles),
                          bulk);
  cp_async_wait<0>();  // this thread's weights (the first unit's copies may still fly)
  keep_weight_nans(base, p, n_layers);
  __syncthreads();

  for (int i = 0, u = blockIdx.x; u < units; ++i, u += gridDim.x) {
    const int cur = buffers == 2 ? (i & 1) : 0, next = u + gridDim.x;
    if (buffers == 2 && next < units) {  // the next unit's copies fly while this one computes
      issue_unit<T, D, ORDER>(raw0 + (cur ^ 1) * L.raw_elems, bar + (cur ^ 1), x, n, d, h0, (next % tiles) * TP,
                              chunk_dir0<D>(d, next / tiles), bulk);
    }
    mbar_wait(bar + cur, (buffers == 2 ? i >> 1 : i) & 1);
    const int n0 = (u % tiles) * TP, chunk = u / tiles, dir0 = chunk_dir0<D>(d, chunk);
    load_operand<T, D, ORDER>(in, hs0, kp0, raw0 + cur * L.raw_elems, h0, min(TP, n - n0), in_actv);
    __syncthreads();
    if (buffers == 1 && next < units) {  // the raw buffer is free: the copies fly during the products
      issue_unit<T, D, ORDER>(raw0, bar, x, n, d, h0, (next % tiles) * TP, chunk_dir0<D>(d, next / tiles), bulk);
    }

    const T* a = in;
    int a_stride = hs0, kpad = kp0;
    const T* w = base;
    const T* bias = base + L.bias;
    for (int l = 0; l < n_layers; ++l) {
      const int hout = p.dims[l + 1], ks = hstride<T>(p.dims[l]), wrows = round_up(hout, kRowTile);
      if (l + 1 < n_layers) {  // a middle layer: pre-activations, then the chain rule in place
        T* const h = hid0 + (l & 1) * L.hid_elems;
        const int hs = L.hid_stride, kn = round_up(hout, Tiles<T>::kK);
        product<T, ROWS>(a, a_stride, w, ks, kpad, wrows, [&](int r, int j, T v) {
          if (j < kn) h[r * hs + j] = j < hout ? (r < TP ? v + bias[j] : v) : T(0);
        });
        __syncthreads();
        chain_rule<T, D, ORDER>(h, hs, hout, actv);
        __syncthreads();
        a = h;
        a_stride = hs;
        kpad = kn;
      } else {  // the output layer: staged for the stores
        product<T, ROWS>(a, a_stride, w, ks, kpad, wrows, [&](int r, int j, T v) {
          if (j < hout) stage[r * hout + j] = r < TP ? v + bias[j] : v;
        });
        __syncthreads();
      }
      w += wrows * ks;
      bias += round_up(hout, 4);
    }
    store_unit<T, D, ORDER>(stage, out, n, d, dir0, n_out, n0, D != kMaxDims || chunk == 0);
    __syncthreads();  // the stage and the operand are free
  }
}

// ---------------------------------------------------------------- host side
template <typename T>
struct Launch {
  template <int D, int ORDER>
  struct At {
    static int run(const T* x, int n, int d, int n_layers, const MLPParams<T>* p, int actv, int in_actv,
                   int buffers, int bulk, int blocks, T* out, cudaStream_t stream) {
      constexpr int S = 1 + ORDER * D;
      const int units = (n + Tiles<T>::kTile - 1) / Tiles<T>::kTile * chunks_of(d);
      if (blocks < 1 || blocks > units) return kInvalid;
      const size_t smem = layout<T>(p->dims, n_layers, S, buffers).bytes;
      if (smem > kSmemLimit) return kInvalid;
      // raise the kernel's dynamic shared-memory ceiling once per device, to the limit
      static bool ceiling_set[kMaxDevices] = {};
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 0 || dev >= kMaxDevices) return kInvalid;
      if (!ceiling_set[dev]) {
        err = cudaFuncSetAttribute(taylor_mlp_streams_kernel<T, D, ORDER>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
        if (err != cudaSuccess) return static_cast<int>(err);
        ceiling_set[dev] = true;
      }
      taylor_mlp_streams_kernel<T, D, ORDER><<<blocks, kThreads, smem, stream>>>(x, n, d, n_layers, *p, actv,
                                                                                 in_actv, buffers, bulk, out);
      return static_cast<int>(cudaGetLastError());
    }
  };
};

template <typename T>
int forward(const void* x, int n, int d, int n_layers, const int* dims, const void* const* W,
            const void* const* b, int order, int actv, int in_actv, int buffers, int bulk, int blocks, void* out,
            void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n < 1 || (buffers != 1 && buffers != 2) ||
      (actv != kActTanh && actv != kActSin) ||
      (in_actv != kActNone && in_actv != kActTanh && in_actv != kActSin)) {
    return kInvalid;
  }
  if (bulk && ((dims[0] * sizeof(T)) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)) return kInvalid;
  MLPParams<T> p;
  for (int l = 0; l < n_layers; ++l) {
    p.W[l] = static_cast<const T*>(W[l]);
    p.b[l] = static_cast<const T*>(b[l]);
  }
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return kInvalid;
    p.dims[l] = dims[l];
  }
  return dispatch<Launch<T>::template At>(d, order, static_cast<const T*>(x), n, d, n_layers,
                                          static_cast<const MLPParams<T>*>(&p), actv, in_actv, buffers, bulk,
                                          blocks, static_cast<T*>(out), static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for arguments the kernel does not take. x: device
// input streams (1 + order * d, n, dims[0]); out: the device output stack
// (1 + order * d, n, dims[n_layers]); dims, W, b: host arrays of n_layers +
// 1 ints and n_layers device pointers, weights in nn.Linear's (n_out, n_in)
// row-major layout. in_actv: -1 none, 0 tanh, 1 sin. buffers: raw input
// buffers (1 or 2; the launch fails where the layout passes the shared
// memory of a block); bulk: a tile's input streams come by bulk copy
// (dims[0] * the element size a multiple of 16 and x 16-byte aligned), else
// element by element; blocks: the persistent grid.
//
// The build compiles this file once per entry point, with -DNDTORCH_ENTRY=1
// and 2 (the order below); with no NDTORCH_ENTRY one compile holds both.
#ifndef NDTORCH_ENTRY
#define NDTORCH_ENTRY 0
#endif

#if NDTORCH_ENTRY == 0 || NDTORCH_ENTRY == 1
int taylor_mlp_streams_f32(const void* x, int n, int d, int n_layers, const int* dims, const void* const* W,
                           const void* const* b, int order, int actv, int in_actv, int buffers, int bulk,
                           int blocks, void* out, void* stream) {
  return forward<float>(x, n, d, n_layers, dims, W, b, order, actv, in_actv, buffers, bulk, blocks, out, stream);
}
#endif

#if NDTORCH_ENTRY == 0 || NDTORCH_ENTRY == 2
int taylor_mlp_streams_f64(const void* x, int n, int d, int n_layers, const int* dims, const void* const* W,
                           const void* const* b, int order, int actv, int in_actv, int buffers, int bulk,
                           int blocks, void* out, void* stream) {
  return forward<double>(x, n, d, n_layers, dims, W, b, order, actv, in_actv, buffers, bulk, blocks, out, stream);
}
#endif

}  // extern "C"
