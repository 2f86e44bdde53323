// y = A x for one direction of a blocked-ELL operand (kernel K2s).
//
// Replaces the sparse use of the TPU kernel _batched_kernel of
// scs_tpu/ops/dsmatvec.py (K2), which scs_tpu/ops/sparse.py:331-340
// (ds_ell_matvec) launches with one grid step a block-row on x gathered
// per block-row. The same kernel body, templated on the element type, also
// takes the two products the JAX package leaves to an XLA einsum
// (scs_tpu/ops/sparse.py:122-127, ell_matvec): the indirect CG's float32
// shadow and the pure float64 path. Kinds:
//   pair  (hi, lo) float32 pair, float64 x and y: hi + lo is exact in a
//         double, so each element is formed as (double)hi + (double)lo and
//         multiplied by x with a float64 FMA (the mixed path's A x, A' z);
//   f32   float32 tiles, x and y, float32 FMAs (the CG's shadow product);
//   f64   float64 tiles, x and y (the pure path).
//
// The operand (ops/sparse.py): nbr = ceil(m / bm) block-rows of bm rows,
// each holding kmax tile slots of bn columns side by side, row-major
// (nbr, bm, kmax * bn); idx (nbr, kmax) int32 the column block of each
// slot; count (nbr,) int32 the slots that hold a tile, which come first.
// Slots past the count are padding and are never read.
//
// What bounds it: a stored element is 8 bytes (pair, f64) or 4 (f32) read
// once for 2-3 operations, ~0.4 operations a byte, far below the ~10 the
// card's float64 units need: device memory. So the design reads the tiles
// once with coalesced 16-byte streaming loads and nothing else from device
// memory that scales with them:
// - x is read through the tile indices. It is at most a few MB and stays
//   in the 50 MB L2; the 8 lanes that share a column chunk read it at one
//   address (one transaction). There is no gathered copy of x.
// - A block-row's loop stops at its count: padded slots cost nothing.
// - The wrapper re-tiles an operand at a narrower bn where its tiles are
//   sparsely filled (ops/sparse.choose_width), so fewer stored zeros are
//   read; the kernel takes bn = 16, 32, 64 or 128 on its fast path.
// Fast path (bm = 8, 16-byte aligned tiles): wpr warps a block-row (1 where
// the block-rows fill the card, up to 8 where they are few and long: the
// host's launch_config), each warp a contiguous share of its tiles, four
// lanes a row; lane (i, q) of a warp takes row i and, in each tile, the
// chunks of 4 columns q, q + 4, ... (bn / 16 chunks), so a warp's load
// instruction covers 8 rows x 64 contiguous bytes. A lane keeps kItems
// chunks of A and x in flight before it uses any. The tile indices of up
// to 32 slots sit one a lane and are shuffled to the others. Rows are
// summed in two accumulators, then over the row's four lanes by shuffles,
// then over the block-row's warps in warp order through shared memory, and
// written by one lane: a fixed order and no atomics, so the card repeats a
// product bit for bit. x takes 16-byte loads where it is 16-byte aligned
// (a chunk past n is read as masked scalars); columns past n hold zero
// tiles and read x as 0. Block-rows go on gridDim.x (no 65535 limit).
// Other bm or bn, or unaligned tiles: one thread a row walks its tiles in
// order (correct, not tuned).
//
// The indirect backend replays these products inside CUDA graphs, so a
// launch allocates nothing, does not synchronise and sets no function
// attribute; its only shared memory is a static 512-byte array.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kBm = 8;         // rows of a tile on the fast path
constexpr int kWarps = 8;      // warps a block on the fast path
constexpr int kItems = 4;      // chunks a lane has in flight
constexpr int kGeneric = 128;  // threads a block on the generic path
constexpr unsigned kFull = 0xffffffffu;

struct Pair {
  using X = double;
  using Acc = double;
  struct Chunk {
    float4 h, l;
  };
  static __device__ __forceinline__ Chunk load(const void* a, const void* alo,
                                               long long o) {
    return {__ldcs(reinterpret_cast<const float4*>(
                static_cast<const float*>(a) + o)),
            __ldcs(reinterpret_cast<const float4*>(
                static_cast<const float*>(alo) + o))};
  }
  static __device__ __forceinline__ void fma4(const Chunk& c, const X* x,
                                              Acc& a0, Acc& a1) {
    a0 = fma(static_cast<double>(c.h.x) + static_cast<double>(c.l.x), x[0], a0);
    a1 = fma(static_cast<double>(c.h.y) + static_cast<double>(c.l.y), x[1], a1);
    a0 = fma(static_cast<double>(c.h.z) + static_cast<double>(c.l.z), x[2], a0);
    a1 = fma(static_cast<double>(c.h.w) + static_cast<double>(c.l.w), x[3], a1);
  }
  static __device__ __forceinline__ Acc elem(const void* a, const void* alo,
                                             long long o) {
    return static_cast<double>(__ldg(static_cast<const float*>(a) + o)) +
           static_cast<double>(__ldg(static_cast<const float*>(alo) + o));
  }
};

struct F32 {
  using X = float;
  using Acc = float;
  struct Chunk {
    float4 v;
  };
  static __device__ __forceinline__ Chunk load(const void* a, const void*,
                                               long long o) {
    return {__ldcs(reinterpret_cast<const float4*>(
        static_cast<const float*>(a) + o))};
  }
  static __device__ __forceinline__ void fma4(const Chunk& c, const X* x,
                                              Acc& a0, Acc& a1) {
    a0 = fmaf(c.v.x, x[0], a0);
    a1 = fmaf(c.v.y, x[1], a1);
    a0 = fmaf(c.v.z, x[2], a0);
    a1 = fmaf(c.v.w, x[3], a1);
  }
  static __device__ __forceinline__ Acc elem(const void* a, const void*,
                                             long long o) {
    return __ldg(static_cast<const float*>(a) + o);
  }
};

struct F64 {
  using X = double;
  using Acc = double;
  struct Chunk {
    double2 p, q;
  };
  static __device__ __forceinline__ Chunk load(const void* a, const void*,
                                               long long o) {
    const double2* p =
        reinterpret_cast<const double2*>(static_cast<const double*>(a) + o);
    return {__ldcs(p), __ldcs(p + 1)};
  }
  static __device__ __forceinline__ void fma4(const Chunk& c, const X* x,
                                              Acc& a0, Acc& a1) {
    a0 = fma(c.p.x, x[0], a0);
    a1 = fma(c.p.y, x[1], a1);
    a0 = fma(c.q.x, x[2], a0);
    a1 = fma(c.q.y, x[3], a1);
  }
  static __device__ __forceinline__ Acc elem(const void* a, const void*,
                                             long long o) {
    return __ldg(static_cast<const double*>(a) + o);
  }
};

// the four entries of x from column col (a multiple of 4): 16-byte loads
// where x is aligned and the chunk lies inside n, else masked scalars
template <typename X, bool kVecX>
__device__ __forceinline__ void load_x(const X* x, int col, int n, X* v) {
  if (kVecX && col + 4 <= n) {
    if constexpr (std::is_same<X, double>::value) {
      const double2* p = reinterpret_cast<const double2*>(x + col);
      const double2 a = __ldg(p);
      const double2 b = __ldg(p + 1);
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    } else {
      const float4 a = __ldg(reinterpret_cast<const float4*>(x + col));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = col + j < n ? __ldg(x + col + j) : X(0);
  }
}

template <class E, int kBn, bool kVecX>
__global__ void __launch_bounds__(kWarps * 32)
ell_matvec_fast(const void* __restrict__ a, const void* __restrict__ alo,
                const int* __restrict__ idx, const int* __restrict__ count,
                const typename E::X* __restrict__ x,
                typename E::X* __restrict__ y, int m, int n, int nbr,
                int kmax, int wpr) {
  using X = typename E::X;
  using Acc = typename E::Acc;
  constexpr int kPer = kBn / 16;  // chunks of a tile a lane takes
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * (kWarps / wpr) + warp / wpr;
  const int part = warp % wpr;  // this warp's share of block-row r
  const bool live = r < nbr;    // no early return: the block syncs below
  const int lane = threadIdx.x & 31;
  const int i = lane >> 2;
  const int q = lane & 3;
  const long long row = static_cast<long long>(r) * kBm + i;
  const long long K = static_cast<long long>(kmax) * kBn;  // row stride
  const long long base = row * K + 4 * q;
  const int* ridx = idx + static_cast<long long>(r) * kmax;
  const int cnt = live ? __ldg(count + r) : 0;
  const int per = (cnt + wpr - 1) / wpr;
  const int lo = min(part * per, cnt);
  const int hi = min(lo + per, cnt);

  Acc acc0 = Acc(0), acc1 = Acc(0);
  for (int w0 = lo; w0 < hi; w0 += 32) {
    // the column blocks of up to 32 slots, one a lane
    const int wn = min(hi - w0, 32);
    const int mine = lane < wn ? __ldg(ridx + w0 + lane) : 0;
    const int total = wn * kPer;
    for (int k0 = 0; k0 < total; k0 += kItems) {
      typename E::Chunk av[kItems];
      X xv[kItems][4];
#pragma unroll
      for (int s = 0; s < kItems; ++s) {
        const int k = k0 + s;
        const int t = k / kPer;
        const int u = k % kPer;
        const int cb = __shfl_sync(kFull, mine, t & 31);
        if (k < total) {
          av[s] = E::load(a, alo,
                          base + static_cast<long long>(w0 + t) * kBn + 16 * u);
          load_x<X, kVecX>(x, cb * kBn + 4 * q + 16 * u, n, xv[s]);
        }
      }
#pragma unroll
      for (int s = 0; s < kItems; ++s) {
        if (k0 + s < total) E::fma4(av[s], xv[s], acc0, acc1);
      }
    }
  }
  Acc acc = acc0 + acc1;
  acc += __shfl_xor_sync(kFull, acc, 1);
  acc += __shfl_xor_sync(kFull, acc, 2);
  if (wpr == 1) {
    if (q == 0 && live && row < m) y[row] = acc;
    return;
  }
  // the block-row's warps meet in shared memory, summed in warp order
  __shared__ Acc parts[kWarps][kBm];
  if (q == 0) parts[warp][i] = acc;
  __syncthreads();
  if (part == 0 && q == 0 && live && row < m) {
    Acc sum = parts[warp][i];
    for (int w = 1; w < wpr; ++w) sum += parts[warp + w][i];
    y[row] = sum;
  }
}

template <class E>
__global__ void __launch_bounds__(kGeneric)
ell_matvec_generic(const void* __restrict__ a, const void* __restrict__ alo,
                   const int* __restrict__ idx, const int* __restrict__ count,
                   const typename E::X* __restrict__ x,
                   typename E::X* __restrict__ y, int m, int n, int bm,
                   int bn, int kmax) {
  using Acc = typename E::Acc;
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const long long r = row / bm;
  const long long K = static_cast<long long>(kmax) * bn;
  const long long base = row * K;
  const int cnt = __ldg(count + r);
  Acc acc = Acc(0);
  for (int t = 0; t < cnt; ++t) {
    const long long c0 = static_cast<long long>(__ldg(idx + r * kmax + t)) * bn;
    for (int j = 0; j < bn && c0 + j < n; ++j) {
      acc += E::elem(a, alo, base + static_cast<long long>(t) * bn + j) *
             static_cast<Acc>(__ldg(x + c0 + j));
    }
  }
  y[row] = acc;
}

struct Args {
  const void* a;
  const void* alo;
  const int* idx;
  const int* count;
  const void* x;
  void* y;
  int m, n, bm, bn, kmax, wpr;
};

template <class E, int kBn>
void run_fast(cudaStream_t s, int vec_x, const Args& g) {
  using X = typename E::X;
  const int nbr = (g.m + g.bm - 1) / g.bm;
  const int rows = kWarps / g.wpr;  // block-rows a block
  const dim3 grid((nbr + rows - 1) / rows);
  const X* x = static_cast<const X*>(g.x);
  X* y = static_cast<X*>(g.y);
  if (vec_x) {
    ell_matvec_fast<E, kBn, true><<<grid, kWarps * 32, 0, s>>>(
        g.a, g.alo, g.idx, g.count, x, y, g.m, g.n, nbr, g.kmax, g.wpr);
  } else {
    ell_matvec_fast<E, kBn, false><<<grid, kWarps * 32, 0, s>>>(
        g.a, g.alo, g.idx, g.count, x, y, g.m, g.n, nbr, g.kmax, g.wpr);
  }
}

template <class E>
int run(cudaStream_t s, int fast, int vec_x, const Args& g) {
  if (fast) {
    if (g.bm != kBm || g.wpr <= 0 || kWarps % g.wpr != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (g.bn) {
      case 16: run_fast<E, 16>(s, vec_x, g); break;
      case 32: run_fast<E, 32>(s, vec_x, g); break;
      case 64: run_fast<E, 64>(s, vec_x, g); break;
      case 128: run_fast<E, 128>(s, vec_x, g); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    using X = typename E::X;
    const dim3 grid((g.m + kGeneric - 1) / kGeneric);
    ell_matvec_generic<E><<<grid, kGeneric, 0, s>>>(
        g.a, g.alo, g.idx, g.count, static_cast<const X*>(g.x),
        static_cast<X*>(g.y), g.m, g.n, g.bm, g.bn, g.kmax);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted). Does not synchronise. kind: 0 the (hi, lo) pair
// (a = hi, alo = lo; x and y float64), 1 float32, 2 float64 (alo unused).
// m rows, n columns, tiles of bm x bn, kmax slots a block-row. fast (bm =
// 8, bn 16/32/64/128, tiles 16-byte aligned), wpr (warps a block-row on
// the fast path: 1, 2, 4 or 8) and vec_x (x 16-byte aligned) come from the
// host's launch_config (ops/ellmatvec.py).
int scs_ell_matvec(int kind, const void* a, const void* alo, const void* idx,
                   const void* count, const void* x, void* y, int m, int n,
                   int bm, int bn, int kmax, int fast, int wpr, int vec_x,
                   void* stream) {
  if (m <= 0) return 0;
  if (bm <= 0 || bn <= 0 || kmax <= 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args g{a, alo, static_cast<const int*>(idx),
               static_cast<const int*>(count), x, y, m, n, bm, bn, kmax,
               wpr};
  switch (kind) {
    case 0: return run<Pair>(s, fast, vec_x, g);
    case 1: return run<F32>(s, fast, vec_x, g);
    case 2: return run<F64>(s, fast, vec_x, g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* scs_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
