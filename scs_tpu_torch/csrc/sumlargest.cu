// The path-following projection onto the sum-of-k-largest cone
// {(t, x): sum of the k largest of x <= t} of a sorted (descending) x,
// one thread per cone: the vector step of the sum-of-k-largest-
// eigenvalues cone projection.
//
// Replaces no Pallas kernel: the JAX package leaves this loop to XLA
// (scs_tpu/cones/spectral.py: proj_sum_largest_sorted :99-145, a
// while_loop of at most 2n + 4 passes, after SCS's
// sum_largest_cone.c:42-147). As PyTorch ops each pass is ~40 small
// launches over all cones; run as CUDA graph blocks of 8 passes with a
// host read after each block, one projection of the large spectral
// program (n = 40) took ~3 ms, most of it graph launches, buffer copies
// and host reads.
//
// What bounds it: neither bytes nor the card's peak rate. Each cone reads
// n + 1 values and writes n + 1, and its thread runs up to 2n + 4
// dependent passes of a dozen scalar operations: latency, the slowest
// cone setting the time. The design keeps each cone in one thread (the
// passes are scalar; the two reads of x per pass are gathers from the
// cone's own row), no synchronisation, any count of cones in one launch.
//
// The arithmetic is the plain version's (`scs_tpu_torch/cones/
// spectral.py`, `_sum_largest_sorted_plain`) operation for operation, so
// the two agree to the last bit but for the first sum of k entries, which
// the plain version's torch reduction may add in another order.

#include <cuda_runtime.h>

namespace {

constexpr double kTolLargest = 1e-9;

// torch.minimum: NaN where either is NaN
template <typename T> __device__ T tmin(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

template <typename T>
__global__ void sum_largest_kernel(const T* __restrict__ t0_in,
                                   const T* __restrict__ x_in,
                                   T* __restrict__ t_out,
                                   T* __restrict__ x_out, long long count,
                                   int n, int k) {
  const long long c = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (c >= count) return;
  const T* x = x_in + c * n;
  T* xo = x_out + c * n;
  const T t0 = t0_in[c];
  const T kf = T(k);
  T S = 0;
  for (int i = 0; i < k; ++i) S += x[i];
  T t = t0, eta = 0, a_u = x[k - 1], a_t = x[k];
  int nu = k, nt = 0;
  for (int it = 0; S > t + T(kTolLargest) && it < 2 * n + 4; ++it) {
    const T nuf = T(nu), ntf = T(nt);
    const bool at_k = nu == k;
    const T ratio = at_k ? T(1) : ntf / (kf - nuf);
    const T s1 = at_k ? a_u - a_t
                      : (a_u - a_t) / ((at_k || ratio == T(1)) ? T(1)
                                                               : ratio - T(1));
    const T s3 = (S - t) / (ratio * (nuf + T(1)) + (kf - nuf));
    T s = nu == 0 ? s3 : tmin(s3, s1);
    const bool mid = !((nu + nt == n) || nt == 0);
    const T val = a_t - x[nu + nt < n - 1 ? nu + nt : n - 1];
    if (mid) s = tmin(s, val);
    eta = eta + s * ratio;
    S = S - s * (ratio * nuf + kf - nuf);
    t = t0 + eta;
    if (nt > 0) a_t = a_t - s;
    if (nu != 0 && s == s1) nu -= 1;
    if (nu > 0) a_u = x[nu - 1] - eta;
    nt = nt == 0 ? 2 : nt + 1;
  }
  nt = nt - 1 > 0 ? nt - 1 : 0;
  for (int i = 0; i < n; ++i)
    xo[i] = i < nu ? x[i] - eta : (i < nu + nt ? a_t : x[i]);
  t_out[c] = t;
}

template <typename T>
int launch(const void* t0, const void* x, void* t, void* xo, long long count,
           int n, int k, void* stream) {
  if (count <= 0) return 0;
  constexpr int kThreads = 128;
  const dim3 grid(static_cast<unsigned>((count + kThreads - 1) / kThreads));
  sum_largest_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(t0), static_cast<const T*>(x),
      static_cast<T*>(t), static_cast<T*>(xo), count, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted). Does not synchronise. t0 (count,), x (count, n)
// contiguous float64, each row sorted descending, 0 < k < n; t (count,),
// xo (count, n) out.
int scs_sum_largest(const void* t0, const void* x, void* t, void* xo,
                    long long count, int n, int k, void* stream) {
  return launch<double>(t0, x, t, xo, count, n, k, stream);
}

const char* scs_sumlargest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
