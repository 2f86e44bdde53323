// y = A x for A held as an (hi, lo) float32 pair.
//
// Replaces three TPU kernels of scs_tpu/ops/dsmatvec.py, the double-single
// matvec that the mixed direct solve and the residual checks run:
//   K1  _kernel, launched by _ds_matvec_padded, one problem (batch = 1);
//   K2  _batched_kernel, launched by _ds_matvec_batched, B problems in
//       shared grid steps (batch = B, one blockIdx.z per problem);
//   K3  the same kernels launched by _pair_padded / _pair_batched, which
//       return the (hi, lo) float32 pair of each sum unsummed (ylo given).
//
// x is float64, or float32 in the float32-state fast phase (x_f32 != 0).
// The output is y in x's type, or, for K3 (float32 x), the float32 pair
// yhi = f32(acc), ylo = f32(acc - yhi), whose sum carries ~48 bits of the
// float64 sum: the fast phase's refinement residual r = (b - yhi) - ylo
// then cancels exactly (dsmatvec.py:357-366).
//
// Why the arithmetic differs from the TPU kernel: the TPU has no float64
// hardware, so that kernel forms ~2^-48-accurate products and sums from
// error-free float32 transformations (Dekker two_prod, Knuth two_sum). An
// H100 has float64 units. Each element hi + lo is exact in a double, so
// this kernel forms (double)hi + (double)lo, multiplies by x with a float64
// FMA and accumulates in float64: the same bytes are read and the result
// is more accurate than the TPU kernel's (plain float64 rounding, ~1e-16
// relative per operation, against the contract of ~2^-48).
//
// What bounds it: every element of A costs 8 bytes read (two float32) and
// 3 float64 operations (add, multiply-add). At 3.35 TB/s and 34 TFLOP/s of
// float64 the reads take ~10x longer than the arithmetic, so the kernel is
// bound by device memory: the design keeps enough bytes in flight with
// coalesced 16-byte loads. Two other limits shape it: the float32 to
// float64 conversions (F2F.F64.F32, 16 a clock per SM in the CUDA C++
// Programming Guide's throughput table; two per element, three with a
// float32 x) and, for small products, latency.
// - kTpr threads share one row (a template parameter, 8 to 256), chosen
//   by the host (`launch_config` in ops/dsmatvec.py): kUnroll loads a
//   thread where the loads outnumber the threads the card holds, one load
//   a thread in a small product, and at most 32 (a row within a warp)
//   where a warp per row would fill the card. Rows of 100 in a batch (the
//   headline family's A, K and G) take 8 threads, so a warp holds four
//   rows and the shuffle tree has 3 steps; the large SOCP's rows of 2048
//   take 128 threads over four warps, combined through shared memory, so
//   that the 2048 rows of its K still fill the card.
// - On 16-byte aligned rows a thread issues kUnroll = 4 chunks of hi, lo
//   and x before it uses any (explicit batching, not a loop the compiler
//   may leave rolled), into two independent accumulators. A chunk past the
//   row is neither loaded nor converted. A float32 x is converted where it
//   is used, not where it is loaded: a conversion waiting on its load
//   would hold back the next chunk's loads.
// - A's loads and x's loads are vectorised independently. A (hi and lo)
//   takes float4 loads when both base pointers are 16-byte aligned and the
//   row and batch strides are multiples of 4 floats (vec_a); a row's n % 4
//   tail is read as scalars. x takes 16-byte loads (two double2 or one
//   float4) only when it is aligned too (vec_x); otherwise it is read as
//   scalars, which hit L1/L2 since every row of a block reads the same x.
//   So an x that is a column slice of the (B, l) iterate (batch stride
//   l = n + m + 1, odd) no longer costs A its float4 loads. Without vec_a
//   (n % 4 != 0, or an offset view) everything is read as scalars in a
//   compact loop.
// Neighbouring threads read neighbouring addresses. Each row's sum is
// reduced in registers and shuffles (and shared memory across the warps of
// a row), and each row is written by one thread, so no sum crosses a block
// and nothing is carried between blocks (the TPU kernel's sequential
// grid-axis accumulation into a resident output block has no counterpart
// here). Rows past m and columns past n are masked, so the (hi, lo) pair
// needs no padding.
//
// K2: blockIdx.z indexes a batch of independent problems, each at its own
// offset (a_bstride for hi/lo, x_bstride for x, y_bstride for y), so the
// batched solver launches this same kernel for B problems at once. The
// TPU kernel groups several problems into one grid step to save per-step
// overhead; here the grid is (ceil(m / rows per block), 1, B) blocks and
// the hardware schedules them. gridDim.z is at most 65535, which the
// wrapper checks. The block is 64, 128 or 256 threads, whichever leaves
// the fewest idle rows in a problem's last block.
//
// The indirect backend replays K1/K2 inside CUDA graphs, so a launch
// allocates nothing, does not synchronise and sets no function attribute:
// the only shared memory is a static 64-byte array.

#include <cuda_runtime.h>

namespace {

constexpr int kUnroll = 4;  // chunks a thread has in flight
constexpr int kMaxThreads = 256;

__device__ __forceinline__ double elem(float h, float l, double x,
                                       double acc) {
  return fma(static_cast<double>(h) + static_cast<double>(l), x, acc);
}

// the four entries of x from 4 k, as stored: 16-byte loads when aligned,
// else scalars. A float32 x is converted where it is used, so that no
// conversion waits on its load before the next chunk's loads are issued.
template <bool kVecX>
__device__ __forceinline__ void load4(const double* x, int k, double* v) {
  if constexpr (kVecX) {
    const double2* x2 = reinterpret_cast<const double2*>(x) + 2 * k;
    const double2 a = __ldg(x2);
    const double2 c = __ldg(x2 + 1);
    v[0] = a.x; v[1] = a.y; v[2] = c.x; v[3] = c.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(x + 4 * k + j);
  }
}

template <bool kVecX>
__device__ __forceinline__ void load4(const float* x, int k, float* v) {
  if constexpr (kVecX) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x) + k);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(x + 4 * k + j);
  }
}

__device__ __forceinline__ void store(double acc, double* y, float*,
                                      long long i) {
  y[i] = acc;
}

__device__ __forceinline__ void store(double acc, float* y, float* ylo,
                                      long long i) {
  const float h = static_cast<float>(acc);
  y[i] = h;
  if (ylo != nullptr) ylo[i] = static_cast<float>(acc - static_cast<double>(h));
}

// kTpr threads per row; XT: x's type; YT: y's type (double, or float for a
// float32 y or a pair)
template <int kTpr, bool kVecA, bool kVecX, typename XT, typename YT>
__global__ void __launch_bounds__(kMaxThreads)
ds_matvec_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                 const XT* __restrict__ x, YT* __restrict__ y,
                 float* __restrict__ ylo,
                 int m, int n, long long lda, long long a_bstride,
                 long long x_bstride, long long y_bstride) {
  const int sl = threadIdx.x % kTpr;
  const long long row = static_cast<long long>(blockIdx.x) *
                            (blockDim.x / kTpr) + threadIdx.x / kTpr;
  const bool valid = row < m;  // no early return: every lane shuffles
  const long long b = blockIdx.z;

  double acc0 = 0.0, acc1 = 0.0;
  if (valid) {
    const float* h = hi + b * a_bstride + row * lda;
    const float* l = lo + b * a_bstride + row * lda;
    const XT* xb = x + b * x_bstride;
    if constexpr (kVecA) {
      const int n4 = n >> 2;
      const float4* h4 = reinterpret_cast<const float4*>(h);
      const float4* l4 = reinterpret_cast<const float4*>(l);
      for (int base = sl; base < n4; base += kTpr * kUnroll) {
        float4 a[kUnroll], c[kUnroll];
        XT xv[kUnroll][4];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = base + u * kTpr;
          if (k < n4) {
            a[u] = __ldg(h4 + k);
            c[u] = __ldg(l4 + k);
            load4<kVecX>(xb, k, xv[u]);
          }
        }
        // only the chunks loaded: a slot past the row would cost its
        // conversions for nothing
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (base + u * kTpr < n4) {
            acc0 = elem(a[u].x, c[u].x, xv[u][0], acc0);
            acc1 = elem(a[u].y, c[u].y, xv[u][1], acc1);
            acc0 = elem(a[u].z, c[u].z, xv[u][2], acc0);
            acc1 = elem(a[u].w, c[u].w, xv[u][3], acc1);
          }
        }
      }
      if (sl < (n & 3)) {  // the n % 4 tail (kTpr >= 8 > 3)
        const int k = (n4 << 2) + sl;
        acc0 = elem(__ldg(h + k), __ldg(l + k),
                    static_cast<double>(__ldg(xb + k)), acc0);
      }
    } else {
      // A's rows unaligned (rare: n % 4 != 0 or an offset view): scalar
      // loads in a compact loop, which keeps tiny products at their launch
      // latency
#pragma unroll 4
      for (int k = sl; k < n; k += kTpr) {
        acc0 = elem(__ldg(h + k), __ldg(l + k), __ldg(xb + k), acc0);
      }
    }
  }
  double acc = acc0 + acc1;
  constexpr int kWidth = kTpr < 32 ? kTpr : 32;
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if constexpr (kTpr > 32) {
    // a row spans kTpr / 32 warps: their lane 0s meet in shared memory
    __shared__ double part[kMaxThreads / 32];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) part[warp] = acc;
    __syncthreads();
    if (sl == 0 && valid) {
      double s = part[warp];
#pragma unroll
      for (int w = 1; w < kTpr / 32; ++w) s += part[warp + w];
      store(s, y, ylo, b * y_bstride + row);
    }
  } else if (sl == 0 && valid) {
    store(acc, y, ylo, b * y_bstride + row);
  }
}

struct Args {
  const float* h;
  const float* l;
  const void* x;
  void* y;
  float* ylo;
  int m, n;
  long long lda, a_bstride, x_bstride, y_bstride;
};

template <int kTpr, bool kVecA, bool kVecX, typename XT, typename YT>
void run(const dim3& grid, int threads, cudaStream_t s, const Args& a) {
  ds_matvec_kernel<kTpr, kVecA, kVecX, XT, YT><<<grid, threads, 0, s>>>(
      a.h, a.l, static_cast<const XT*>(a.x), static_cast<YT*>(a.y), a.ylo,
      a.m, a.n, a.lda, a.a_bstride, a.x_bstride, a.y_bstride);
}

template <int kTpr, typename XT, typename YT>
void run_vec(const dim3& grid, int threads, cudaStream_t s, int vec_a,
             int vec_x, const Args& a) {
  if (vec_a && vec_x) {
    run<kTpr, true, true, XT, YT>(grid, threads, s, a);
  } else if (vec_a) {
    run<kTpr, true, false, XT, YT>(grid, threads, s, a);
  } else {
    run<kTpr, false, false, XT, YT>(grid, threads, s, a);
  }
}

template <typename XT, typename YT>
bool dispatch(int tpr, const dim3& grid, int threads, cudaStream_t s,
              int vec_a, int vec_x, const Args& a) {
  switch (tpr) {
    case 8: run_vec<8, XT, YT>(grid, threads, s, vec_a, vec_x, a); break;
    case 16: run_vec<16, XT, YT>(grid, threads, s, vec_a, vec_x, a); break;
    case 32: run_vec<32, XT, YT>(grid, threads, s, vec_a, vec_x, a); break;
    case 64: run_vec<64, XT, YT>(grid, threads, s, vec_a, vec_x, a); break;
    case 128: run_vec<128, XT, YT>(grid, threads, s, vec_a, vec_x, a); break;
    case 256: run_vec<256, XT, YT>(grid, threads, s, vec_a, vec_x, a); break;
    default: return false;
  }
  return true;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted). Does not synchronise. x is float32 when x_f32 is
// set, else float64; y is x's type. With ylo given (K3, float32 x only),
// y and ylo are the float32 pair, both with y_bstride. tpr (threads per
// row: 8, 16, 32, 64, 128 or 256), threads (per block: 64, 128 or 256, a
// multiple of tpr), vec_a and vec_x come from the host's launch_config;
// vec_a and vec_x promise the alignment described above.
int scs_ds_matvec(const void* hi, const void* lo, const void* x, void* y,
                  void* ylo, int m, int n, long long lda, int batch,
                  long long a_bstride, long long x_bstride,
                  long long y_bstride, int tpr, int threads, int vec_a,
                  int vec_x, int x_f32, void* stream) {
  if (threads != 64 && threads != 128 && threads != 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tpr <= 0 || tpr > threads || threads % tpr != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m <= 0 || batch <= 0) return 0;
  const int rows = threads / tpr;
  const dim3 grid((m + rows - 1) / rows, 1, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{static_cast<const float*>(hi), static_cast<const float*>(lo),
               x, y, static_cast<float*>(ylo), m, n, lda, a_bstride,
               x_bstride, y_bstride};
  bool known;
  if (x_f32) {
    known = dispatch<float, float>(tpr, grid, threads, s, vec_a, vec_x, a);
  } else if (ylo == nullptr) {
    known = dispatch<double, double>(tpr, grid, threads, s, vec_a, vec_x, a);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);  // K3 takes float32 x
  }
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* scs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
