// o[i] = sum_j (a[i, j] + b[i, j]) in float32: the pure-read rowsum that
// witnesses the card's streaming-read bandwidth.
//
// Replaces K5, the Pallas `kernel` of scs_tpu/ops/roofline.py
// (_read_peak_fn), which roofline.measure runs beside the double-single
// matvec (K1) to calibrate the achievable read ceiling: two float32 (m, n)
// arrays in, one float32 per row out, one add and one sum per element.
//
// What bounds it: it reads 8 bytes per element (one float32 of a and of
// b) and does two float32 operations on them, so at 3.35 TB/s and 67
// TFLOP/s of float32 the reads take ~100x longer than the arithmetic:
// bound by device memory, 2 * 4096^2 * 4 B = 134 MB, 0.040 ms at the
// measure's shape. The design therefore only keeps enough reads in
// flight: one warp owns one row and its lanes stride along it, so
// neighbouring lanes read neighbouring addresses, with 16-byte loads
// (float4 of a and of b) where the rows are 16-byte aligned, and the loop
// unrolled four times, so each thread has eight 16-byte loads in flight.
// Four float32 accumulators per thread, then a warp-shuffle reduction;
// each warp writes its own row, so nothing crosses a block (the TPU
// kernel's accumulation across sequential grid steps has no counterpart
// here). Rows past m and columns past n are masked: no padding. The
// float32 sum is taken in another order than the plain version's; each
// thread adds n/128 terms per accumulator (n/32 without 16-byte loads),
// then 7 adds combine them, so at the probe's shapes the two agree to
// 4 ceil(log2 n) 2^-24 sum_j |a + b| per row.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
read_rowsum_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ o, int m, int n, long long lda) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // whole warps leave together
  const float* ar = a + row * lda;
  const float* br = b + row * lda;

  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  int k0 = 0;
  if (kVec) {
    const int n4 = n >> 2;
    const float4* a4 = reinterpret_cast<const float4*>(ar);
    const float4* b4 = reinterpret_cast<const float4*>(br);
#pragma unroll 4
    for (int k = lane; k < n4; k += 32) {
      const float4 x = __ldg(a4 + k);
      const float4 y = __ldg(b4 + k);
      acc0 += x.x + y.x;
      acc1 += x.y + y.y;
      acc2 += x.z + y.z;
      acc3 += x.w + y.w;
    }
    k0 = n4 << 2;
  }
  for (int k = k0 + lane; k < n; k += 32) {
    acc0 += __ldg(ar + k) + __ldg(br + k);
  }
  float acc = (acc0 + acc1) + (acc2 + acc3);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) o[row] = acc;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted). Does not synchronise. a and b are (m, n) with row
// stride lda (floats); o holds m floats. vec: rows 16-byte aligned.
int scs_read_rowsum(const void* a, const void* b, void* o, int m, int n,
                    long long lda, int vec, void* stream) {
  if (m <= 0) return 0;
  const dim3 grid((m + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* av = static_cast<const float*>(a);
  const float* bv = static_cast<const float*>(b);
  float* ov = static_cast<float*>(o);
  if (vec) {
    read_rowsum_kernel<true><<<grid, block, 0, s>>>(av, bv, ov, m, n, lda);
  } else {
    read_rowsum_kernel<false><<<grid, block, 0, s>>>(av, bv, ov, m, n, lda);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* scs_readpeak_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
