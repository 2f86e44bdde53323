// The path-following projection onto the sum-of-k-largest cone
// {(t, x): sum of the k largest of x <= t} of a sorted (descending) x,
// one thread per cone, the rows in shared memory from n = 14 on: the
// vector step of the sum-of-k-largest-eigenvalues cone projection.
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
// cone setting the time. Each pass reads x at two data-dependent places of
// the cone's row. The design keeps one thread a cone, with no
// synchronisation between cones, and takes the row's reads off device
// memory: a block stages the rows of its cones (one contiguous span of x)
// in shared memory with coalesced loads, the passes read them there, and
// the projected rows go back through shared memory with coalesced stores.
// A row takes an odd stride of doubles, so the threads of a warp reading
// the same entry of their rows hit distinct banks. Cones a block follow
// n (ops/sumlargest.launch_config): 128 while their rows fit, fewer up to
// 227 KB; beyond that (n above ~29000), and below n = 14, where a
// thread's few passes cost less than the staging, the passes read the
// rows in device memory.
//
// The arithmetic is the plain version's (`scs_tpu_torch/cones/
// spectral.py`, `_sum_largest_sorted_plain`) operation for operation, so
// the two agree to the last bit but for the first sum of k entries, which
// the plain version's torch reduction may add in another order.

#include <cuda_runtime.h>

namespace {

constexpr double kTolLargest = 1e-9;
constexpr int kBatch = 8;

// torch.minimum: NaN where either is NaN
template <typename T> __device__ T tmin(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

// cones c0 .. c0 + cpb - 1 of block c0 / cpb, one a thread; their rows at
// `stride` doubles from each other in dynamic shared memory (kStaged), or
// read in place
template <typename T, bool kStaged>
__global__ void sum_largest_kernel(const T* __restrict__ t0_in,
                                   const T* __restrict__ x_in,
                                   T* __restrict__ t_out,
                                   T* __restrict__ x_out, long long count,
                                   int n, int k, int cpb, int stride) {
  extern __shared__ double rows[];
  const long long c0 = static_cast<long long>(blockIdx.x) * cpb;
  const int nc = static_cast<int>(count - c0 < cpb ? count - c0 : cpb);
  // entry e of the block's span is entry (r, i) of its rows: r, i follow
  // e by steps of blockDim.x without a division each
  const int step_r = blockDim.x / n, step_i = blockDim.x % n;
  if constexpr (kStaged) {
    // kBatch loads in flight a thread before their stores wait on them
    const T* src = x_in + c0 * n;
    const int total = nc * n;
    int r = threadIdx.x / n, i = threadIdx.x % n;
    for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        v[u] = e < total ? src[e] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (e0 + u * static_cast<int>(blockDim.x) < total)
          rows[r * stride + i] = v[u];
        i += step_i;
        r += step_r + (i >= n);
        i -= i >= n ? n : 0;
      }
    }
    __syncthreads();
  }
  if (static_cast<int>(threadIdx.x) < nc) {
    const long long c = c0 + threadIdx.x;
    // shared memory is addressed as such where the rows are staged
    T* xs = kStaged ? rows + threadIdx.x * stride : x_out + c * n;
    const T* x = kStaged ? xs : x_in + c * n;
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
                        : (a_u - a_t) / ((at_k || ratio == T(1))
                                             ? T(1) : ratio - T(1));
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
      xs[i] = i < nu ? x[i] - eta : (i < nu + nt ? a_t : x[i]);
    t_out[c] = t;
  }
  if constexpr (kStaged) {
    __syncthreads();
    T* dst = x_out + c0 * n;
    const int total = nc * n;
    int r = threadIdx.x / n, i = threadIdx.x % n;
    for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
      T v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        v[u] = e < total ? rows[r * stride + i] : T(0);
        i += step_i;
        r += step_r + (i >= n);
        i -= i >= n ? n : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < total) dst[e] = v[u];
      }
    }
  }
}

__global__ void empty_kernel() {}

template <typename T>
int launch(const void* t0, const void* x, void* t, void* xo, long long count,
           int n, int k, int cpb, int threads, int stride, int smem,
           void* stream) {
  if (count <= 0) return 0;
  auto kernel = stride > 0 ? sum_largest_kernel<T, true>
                           : sum_largest_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((count + cpb - 1) / cpb));
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(t0), static_cast<const T*>(x),
      static_cast<T*>(t), static_cast<T*>(xo), count, n, k, cpb, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted). Does not synchronise. t0 (count,), x (count, n)
// contiguous float64, each row sorted descending, 0 < k < n; t (count,),
// xo (count, n) out. The layout (ops/sumlargest.py's launch_config): cpb
// cones and `threads` threads a block, rows `stride` doubles apart in smem
// bytes of dynamic shared memory (stride 0: rows read in place).
int scs_sum_largest(const void* t0, const void* x, void* t, void* xo,
                    long long count, int n, int k, int cpb, int threads,
                    int stride, int smem, void* stream) {
  return launch<double>(t0, x, t, xo, count, n, k, cpb, threads, stride,
                        smem, stream);
}

// one launch of a kernel that does nothing: the floor of a launch's time
int scs_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* scs_sumlargest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
