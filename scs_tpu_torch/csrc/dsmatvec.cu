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
// bound by device memory. The design keeps the reads coalesced: one warp
// owns one row and its lanes stride along it, so neighbouring lanes read
// neighbouring addresses, with 16-byte loads (float4 of hi and of lo, two
// double2 or one float4 of x) where the row and x are 16-byte aligned. x (at most a few
// tens of KB here) is reused by every row and served from L1/L2 through
// the read-only path. The row sum is a warp-shuffle reduction; each warp
// writes its own row, so no sum crosses a block and nothing is carried
// between blocks (the TPU kernel's sequential grid-axis accumulation into a
// resident output block has no counterpart here). Rows past m and columns
// past n are masked, so the (hi, lo) pair needs no padding.
//
// K2: blockIdx.z indexes a batch of independent problems, each at its own
// offset (a_bstride for hi/lo, x_bstride for x, y_bstride for y), so the
// batched solver launches this same kernel for B problems at once and x
// may be a column slice of the (B, l) iterate. The TPU kernel groups
// several problems into one grid step to save per-step overhead; here the
// grid is (ceil(m / 8), 1, B) blocks and the hardware schedules them, so
// nothing is grouped. gridDim.z is at most 65535, which the wrapper checks.
// The 16-byte path needs every problem's rows and x aligned, which the
// wrapper checks over the strides; otherwise all problems take the scalar
// loads.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ double elem(float h, float l, double x,
                                       double acc) {
  return fma(static_cast<double>(h) + static_cast<double>(l), x, acc);
}

// four consecutive entries of x, from 16-byte aligned loads
__device__ __forceinline__ void load4(const double* x, int k, double* v) {
  const double2* x2 = reinterpret_cast<const double2*>(x);
  const double2 a = __ldg(x2 + 2 * k);
  const double2 c = __ldg(x2 + 2 * k + 1);
  v[0] = a.x; v[1] = a.y; v[2] = c.x; v[3] = c.y;
}

__device__ __forceinline__ void load4(const float* x, int k, double* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(x) + k);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
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

// XT: x's type; YT: y's type (double, or float for a float32 y or a pair)
template <bool kVec, typename XT, typename YT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ds_matvec_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                 const XT* __restrict__ x, YT* __restrict__ y,
                 float* __restrict__ ylo,
                 int m, int n, long long lda, long long a_bstride,
                 long long x_bstride, long long y_bstride) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // whole warps leave together
  const long long b = blockIdx.z;
  const float* h = hi + b * a_bstride + row * lda;
  const float* l = lo + b * a_bstride + row * lda;
  const XT* xb = x + b * x_bstride;

  double acc0 = 0.0, acc1 = 0.0;
  int k0 = 0;
  if (kVec) {
    const int n4 = n >> 2;
    const float4* h4 = reinterpret_cast<const float4*>(h);
    const float4* l4 = reinterpret_cast<const float4*>(l);
#pragma unroll 2
    for (int k = lane; k < n4; k += 32) {
      const float4 a = __ldg(h4 + k);
      const float4 c = __ldg(l4 + k);
      double xv[4];
      load4(xb, k, xv);
      acc0 = elem(a.x, c.x, xv[0], acc0);
      acc1 = elem(a.y, c.y, xv[1], acc1);
      acc0 = elem(a.z, c.z, xv[2], acc0);
      acc1 = elem(a.w, c.w, xv[3], acc1);
    }
    k0 = n4 << 2;
  }
  for (int k = k0 + lane; k < n; k += 32) {
    acc0 = elem(__ldg(h + k), __ldg(l + k),
                static_cast<double>(__ldg(xb + k)), acc0);
  }
  double acc = acc0 + acc1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    store(acc, y, ylo, b * y_bstride + row);
  }
}

template <typename XT, typename YT>
void launch(const dim3& grid, const dim3& block, cudaStream_t s, int vec,
            const float* h, const float* l, const void* x, void* y,
            float* ylo, int m, int n, long long lda, long long a_bstride,
            long long x_bstride, long long y_bstride) {
  const XT* xv = static_cast<const XT*>(x);
  YT* yv = static_cast<YT*>(y);
  if (vec) {
    ds_matvec_kernel<true, XT, YT><<<grid, block, 0, s>>>(
        h, l, xv, yv, ylo, m, n, lda, a_bstride, x_bstride, y_bstride);
  } else {
    ds_matvec_kernel<false, XT, YT><<<grid, block, 0, s>>>(
        h, l, xv, yv, ylo, m, n, lda, a_bstride, x_bstride, y_bstride);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted). Does not synchronise. x is float32 when x_f32 is
// set, else float64; y is x's type. With ylo given (K3, float32 x only),
// y and ylo are the float32 pair, both with y_bstride.
int scs_ds_matvec(const void* hi, const void* lo, const void* x, void* y,
                  void* ylo, int m, int n, long long lda, int batch,
                  long long a_bstride, long long x_bstride,
                  long long y_bstride, int vec, int x_f32, void* stream) {
  if (m <= 0 || batch <= 0) return 0;
  const dim3 grid((m + kWarpsPerBlock - 1) / kWarpsPerBlock, 1, batch);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hi);
  const float* l = static_cast<const float*>(lo);
  float* yl = static_cast<float*>(ylo);
  if (x_f32) {
    launch<float, float>(grid, block, s, vec, h, l, x, y, yl, m, n, lda,
                         a_bstride, x_bstride, y_bstride);
  } else if (yl == nullptr) {
    launch<double, double>(grid, block, s, vec, h, l, x, y, nullptr, m, n,
                           lda, a_bstride, x_bstride, y_bstride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);  // K3 takes float32 x
  }
  return static_cast<int>(cudaGetLastError());
}

const char* scs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
