// C[b] = (Ah[b] + Al[b]) (Bh[b] + Bl[b]) for a batch of (m, k) x (k, n)
// products whose operands are held as (hi, lo) float32 pairs; C float64.
//
// Replaces K4, the Pallas `_kernel` of scs_tpu/ops/dsmatmul.py, launched by
// `_ds_matmul_padded` under `ds_matmul`: a batched C = A B with ~2^-48
// relative accuracy. The TPU has no float64, so that kernel forms each
// product and sum from error-free float32 transformations (Dekker
// two_prod, Knuth two_sum) in rank-1 updates over k chunks, and returns C
// as a float32 pair. An H100 has float64 units: each element hi + lo is
// exact in a double, so this kernel forms (double)hi + (double)lo once, as
// it stages the tile in shared memory, multiplies and accumulates with
// float64 FMA, and writes C in float64. The result is at least as
// accurate (float64 rounding, ~k 2^-53 of sum |a| |b|).
//
// What bounds it: 2 m n k float64 operations against 8 (m k + k n) bytes
// read and 8 m n written per product. At (4, 512, 512) x (4, 512, 512)
// that is 1.07 GFLOP against 25 MB: 0.016 ms at the 67 TFLOP/s of the
// float64 tensor cores, 0.0075 ms at 3.35 TB/s, so operations bind. This
// kernel uses the SIMT float64 FMA units (34 TFLOP/s on an H100 SXM), not
// the tensor cores: a simple tiled product that is right, made fast in a
// later change. Its design: one block of 256 threads per 64 x 64 tile of
// C and batch index (blockIdx.z), a loop over k in steps of 16 that stages
// the float64 A and B tiles in shared memory (16.6 KB), each thread
// accumulating a 4 x 4 patch in registers, so that every element loaded
// from shared memory feeds four FMAs. Neighbouring threads load
// neighbouring addresses of B's rows and C's rows. Ragged edges are
// masked (out-of-range elements are staged as 0), so nothing is padded;
// the TPU kernel's k-chunk accumulation into a resident output block is
// the loop inside the block.

#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kThreads = 256;  // 16 x 16, each a 4 x 4 patch of C

__global__ void __launch_bounds__(kThreads)
ds_matmul_kernel(const float* __restrict__ ah, const float* __restrict__ al,
                 const float* __restrict__ bh, const float* __restrict__ bl,
                 double* __restrict__ c, int m, int n, int k) {
  __shared__ double As[kTileK][kTileM + 1];
  __shared__ double Bs[kTileK][kTileN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long bz = blockIdx.z;
  const int row0 = blockIdx.y * kTileM;
  const int col0 = blockIdx.x * kTileN;
  const long long a_off = bz * static_cast<long long>(m) * k;
  const long long b_off = bz * static_cast<long long>(k) * n;
  const long long c_off = bz * static_cast<long long>(m) * n;

  double acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = 0.0;
  }

  for (int k0 = 0; k0 < k; k0 += kTileK) {
    // A tile (kTileM x kTileK): 4 elements per thread, k fastest
    for (int t = tid; t < kTileM * kTileK; t += kThreads) {
      const int i = t / kTileK;
      const int kk = t % kTileK;
      const int gi = row0 + i;
      const int gk = k0 + kk;
      double v = 0.0;
      if (gi < m && gk < k) {
        const long long off = a_off + static_cast<long long>(gi) * k + gk;
        v = static_cast<double>(__ldg(ah + off)) +
            static_cast<double>(__ldg(al + off));
      }
      As[kk][i] = v;
    }
    // B tile (kTileK x kTileN): n fastest, coalesced
    for (int t = tid; t < kTileK * kTileN; t += kThreads) {
      const int kk = t / kTileN;
      const int j = t % kTileN;
      const int gk = k0 + kk;
      const int gj = col0 + j;
      double v = 0.0;
      if (gk < k && gj < n) {
        const long long off = b_off + static_cast<long long>(gk) * n + gj;
        v = static_cast<double>(__ldg(bh + off)) +
            static_cast<double>(__ldg(bl + off));
      }
      Bs[kk][j] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      double av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int s = 0; s < 4; ++s) bv[s] = Bs[kk][tx + 16 * s];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fma(av[r], bv[s], acc[r][s]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = row0 + ty + 16 * r;
    if (gi >= m) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gj = col0 + tx + 16 * s;
      if (gj < n) c[c_off + static_cast<long long>(gi) * n + gj] = acc[r][s];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted). Does not synchronise. ah/al: (batch, m, k), bh/bl:
// (batch, k, n), c: (batch, m, n), all contiguous.
int scs_ds_matmul(const void* ah, const void* al, const void* bh,
                  const void* bl, void* c, int batch, int m, int n, int k,
                  void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  const dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM,
                  batch);
  ds_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ah), static_cast<const float*>(al),
      static_cast<const float*>(bh), static_cast<const float*>(bl),
      static_cast<double*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

const char* scs_dsmatmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
