// y = A x for A held as an (hi, lo) float32 pair, x and y float64.
//
// Replaces the TPU kernel scs_tpu/ops/dsmatvec.py::_kernel (launched by
// _ds_matvec_padded through pl.pallas_call), the double-single matvec that
// the mixed direct solve and the residual checks run (K1).
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
// double2 of x) where the row and x are 16-byte aligned. x (at most a few
// tens of KB here) is reused by every row and served from L1/L2 through
// the read-only path. The row sum is a warp-shuffle reduction; each warp
// writes its own row, so no sum crosses a block and nothing is carried
// between blocks (the TPU kernel's sequential grid-axis accumulation into a
// resident output block has no counterpart here). Rows past m and columns
// past n are masked, so the (hi, lo) pair needs no padding.
//
// blockIdx.z indexes a batch of independent problems with their own
// strides, so the batched solver can launch the same kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ double elem(float h, float l, double x,
                                       double acc) {
  return fma(static_cast<double>(h) + static_cast<double>(l), x, acc);
}

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ds_matvec_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                 const double* __restrict__ x, double* __restrict__ y,
                 int m, int n, long long lda, long long a_bstride,
                 long long x_bstride, long long y_bstride) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // whole warps leave together
  const long long b = blockIdx.z;
  const float* h = hi + b * a_bstride + row * lda;
  const float* l = lo + b * a_bstride + row * lda;
  const double* xb = x + b * x_bstride;

  double acc0 = 0.0, acc1 = 0.0;
  int k0 = 0;
  if (kVec) {
    const int n4 = n >> 2;
    const float4* h4 = reinterpret_cast<const float4*>(h);
    const float4* l4 = reinterpret_cast<const float4*>(l);
    const double2* x2 = reinterpret_cast<const double2*>(xb);
#pragma unroll 2
    for (int k = lane; k < n4; k += 32) {
      const float4 a = __ldg(h4 + k);
      const float4 c = __ldg(l4 + k);
      const double2 xa = __ldg(x2 + 2 * k);
      const double2 xc = __ldg(x2 + 2 * k + 1);
      acc0 = elem(a.x, c.x, xa.x, acc0);
      acc1 = elem(a.y, c.y, xa.y, acc1);
      acc0 = elem(a.z, c.z, xc.x, acc0);
      acc1 = elem(a.w, c.w, xc.y, acc1);
    }
    k0 = n4 << 2;
  }
  for (int k = k0 + lane; k < n; k += 32) {
    acc0 = elem(__ldg(h + k), __ldg(l + k), __ldg(xb + k), acc0);
  }
  double acc = acc0 + acc1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) y[b * y_bstride + row] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted). Does not synchronise.
int scs_ds_matvec(const void* hi, const void* lo, const void* x, void* y,
                  int m, int n, long long lda, int batch, long long a_bstride,
                  long long x_bstride, long long y_bstride, int vec,
                  void* stream) {
  if (m <= 0 || batch <= 0) return 0;
  const dim3 grid((m + kWarpsPerBlock - 1) / kWarpsPerBlock, 1, batch);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hi);
  const float* l = static_cast<const float*>(lo);
  const double* xv = static_cast<const double*>(x);
  double* yv = static_cast<double*>(y);
  if (vec) {
    ds_matvec_kernel<true><<<grid, block, 0, s>>>(
        h, l, xv, yv, m, n, lda, a_bstride, x_bstride, y_bstride);
  } else {
    ds_matvec_kernel<false><<<grid, block, 0, s>>>(
        h, l, xv, yv, m, n, lda, a_bstride, x_bstride, y_bstride);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* scs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
