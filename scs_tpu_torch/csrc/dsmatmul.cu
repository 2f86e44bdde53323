// C[b] = (Ah[b] + Al[b]) (Bh[b] + Bl[b]) for a batch of (m, k) x (k, n)
// products whose operands are held as (hi, lo) float32 pairs; C float64.
//
// Replaces K4, the Pallas `_kernel` of scs_tpu/ops/dsmatmul.py, launched by
// `_ds_matmul_padded` under `ds_matmul`: a batched C = A B with ~2^-48
// relative accuracy. The TPU has no float64, so that kernel forms each
// product and sum from error-free float32 transformations (Dekker
// two_prod, Knuth two_sum) in rank-1 updates over k chunks, and returns C
// as a float32 pair. An H100 has float64 tensor cores: each element
// hi + lo is exact in a double, so this kernel forms (double)hi +
// (double)lo once per element and block, multiplies on the FP64 tensor
// cores (`mma.sync ... f64`, DMMA in SASS), which accumulate in float64,
// and writes C in float64. The result is at least as accurate (float64
// rounding, ~k 2^-53 of sum |a| |b|).
//
// What bounds it: 2 m n k float64 operations against 8 (m k + k n) bytes
// read and 8 m n written per product. At (4, 512, 512) x (4, 512, 512)
// that is 1.07 GFLOP against 25 MB: 0.016 ms at the 67 TFLOP/s of the
// float64 tensor cores, 0.0075 ms at 3.35 TB/s, so operations bind. Two
// other resources come close, and the design is shaped by them:
// - The conversions. F2F.F64.F32 runs at 16 a clock per SM (the CUDA C++
//   Programming Guide's throughput table; against 128 float64 MMA
//   multiply-adds), so each element is converted once per
//   block (12.6 M elements, 25 M conversions at (4, 512, 512)^2: ~40 % of
//   the MMA time), in a compose pass into a float64 tile, never per warp.
// - Shared memory: the float32 stage written by cp.async and read by the
//   compose pass, the float64 tile written by it and read as fragments,
//   ~1090 wavefronts per step of k against 1024 clocks of MMAs.
// The design:
// - One block of 16 warps per 128 x 64 tile of C and product
//   (blockIdx.z): (4, 512, 512)^2 is 128 blocks on 132 SMs, one wave.
//   Eight MMA warps (4 x 2) own a 32 x 32 patch each, 2 x 4 m16n8
//   accumulators of 4 doubles, and run m16n8k4 DMMAs.
//   Eight producer warps stage and compose. Warp specialisation lets the
//   conversions and the MMAs run at once, two warps of each kind on every
//   SM sub-partition (one of each left the conversions' latency exposed).
// - k runs in steps of kBK = 16. Each producer thread brings its own
//   16-byte chunks of the float32 hi and lo tiles of A and B into shared
//   memory with cp.async (`cg`, zero-filled past the edges) in a ring of
//   kStages = 4 stages, waits for its own copies (cp.async.wait_group,
//   no barrier between producers), and composes the same chunks into one
//   of two float64 tiles.
// - Producers and MMA warps meet at named barriers: a producer arrives at
//   full[b] when tile b is composed and waits at empty[b] before
//   composing into it again; an MMA warp waits at full[b] and arrives at
//   empty[b] when it has multiplied tile b.
// - The float64 tiles have no padding. Their 16-byte units are permuted
//   within each row (an XOR of the unit index with a function of the row)
//   so that both the compose pass's 16-byte stores and the MMA warps'
//   8-byte fragment loads hit distinct banks.
// What holds it back (PERF.md): the MMA warps' loop of fragment loads and
// DMMAs, short of the DMMA peak even without the producers' work, which
// adds its shared-memory traffic and conversions.
// Ragged edges: rows past m and columns past n or k are zero-filled in the
// stage (cp.async with a source size of 0), so nothing is padded. Where k
// (A's rows) or n (B's rows) is not a multiple of 4, or a base pointer is
// not 16-byte aligned, that operand is staged with 4-byte cp.async
// (`ca`) per element instead. C is written from the accumulators, two
// doubles a store where n is even. The TPU kernel's k-chunk accumulation
// into a resident output block is the loop inside the block.
//
// The block uses more than 48 KB of dynamic shared memory; the launcher
// sets that attribute once per device, at the first launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;                 // rows and columns of C a block
constexpr int kBN = 64;
constexpr int kBK = 16;                  // k a step
constexpr int kMmaWarpsM = 4;
constexpr int kMmaWarps = 2 * kMmaWarpsM;  // kMmaWarpsM x 2 patches
constexpr int kProducerWarps = 8;
constexpr int kThreads = 32 * (kMmaWarps + kProducerWarps);
constexpr int kProducerThreads = 32 * kProducerWarps;
constexpr int kStages = 4;               // float32 stages in the ring
constexpr int kWTM = kBM / kMmaWarpsM;   // a warp's patch of C
constexpr int kWTN = kBN / 2;
constexpr int kMT = kWTM / 16;           // m16n8 tiles per warp
constexpr int kNT = kWTN / 8;
constexpr int kTileA = kBM * kBK;        // elements of one operand tile
constexpr int kTileB = kBK * kBN;
constexpr int kChunksA = kTileA / 4;     // 16-byte chunks of hi (or lo)
constexpr int kChunksB = kTileB / 4;
constexpr int kStageFloats = 2 * (kTileA + kTileB);
constexpr size_t kSmemBytes =
    2 * (kTileA + kTileB) * sizeof(double) +
    static_cast<size_t>(kStages) * kStageFloats * sizeof(float);
constexpr int kFull = 1;                 // named barriers kFull + b and
constexpr int kEmpty = 3;                // kEmpty + b, b = 0, 1

static_assert(kWTM % 16 == 0 && kWTN % 8 == 0, "warp patch of m16n8 tiles");
static_assert(kBN % 16 == 0, "B's swizzle permutes groups of 8 units");
static_assert(kChunksA % kProducerThreads == 0 &&
                  kChunksB % kProducerThreads == 0,
              "every producer thread stages whole chunks");
static_assert(kStages >= 2, "at least two stages");
static_assert(kSmemBytes <= 232448, "shared memory of one block");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros where !in (source size 0)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

// Offsets (in doubles) into the float64 tiles, A [kBM][kBK] and B
// [kBK][kBN], row-major with the 16-byte units (pairs of doubles) of a row
// permuted by an XOR. A: unit u of row r at u ^ f(r), f(r) = 0, 3, 4, 7 for
// r % 4 = 0 .. 3, so a half-warp's fragment loads (rows g, columns t + 4 j)
// and a quarter-warp's 16-byte compose stores (two rows of 4 chunks) each
// cover all 16 bank pairs. B: unit u of row k at u ^ (u / 8 % 2) ^ 2 (k % 4)
// within its group of 8 units, for the loads (rows t, columns g) and the
// stores (8 chunks of one row) alike.
__device__ __forceinline__ int a_off(int r, int k) {
  const int f = ((r & 3) << 1) | (r & 1);
  return r * kBK + (((k >> 1) ^ f) << 1) + (k & 1);
}

__device__ __forceinline__ int b_off(int k, int n) {
  const int u = n >> 1;
  return k * kBN + ((u ^ ((u >> 3) & 1) ^ ((k & 3) << 1)) << 1) + (n & 1);
}

// D = A B + D on one m16n8k4 tile: a holds rows g and g + 8 of A at k
// column t, b the k row t of B at column g (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma(double* d, const double* a, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

struct Operands {
  const float* ah;
  const float* al;
  const float* bh;
  const float* bl;
  int m, n, k;
  bool vec_a, vec_b;
};

// Producer thread p's chunks of a step: A chunk c = p + i kProducerThreads
// is row c / 4, k columns 4 (c % 4) ..; B chunk c is k row c / (kBN / 4),
// columns 4 (c % (kBN / 4)) ..; the stage holds hi then lo of A [kBM][kBK],
// then of B [kBK][kBN], as float32.
__device__ __forceinline__ void load_stage(float* raw, const Operands& o,
                                           int row0, int col0, int k0,
                                           int p) {
  float* sah = raw;
  float* sal = raw + kTileA;
  float* sbh = raw + 2 * kTileA;
  float* sbl = sbh + kTileB;
#pragma unroll
  for (int i = 0; i < kChunksA / kProducerThreads; ++i) {
    const int c = p + i * kProducerThreads;
    const int r = c >> 2;
    const int kc = (c & 3) * 4;
    const int gr = row0 + r;
    const int gk = k0 + kc;
    const int s = r * kBK + kc;
    if (o.vec_a) {  // k % 4 == 0: a chunk is all in or all out
      const bool in = gr < o.m && gk < o.k;
      const long long off = in ? static_cast<long long>(gr) * o.k + gk : 0;
      cp16(sah + s, o.ah + off, in);
      cp16(sal + s, o.al + off, in);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = gr < o.m && gk + j < o.k;
        const long long off =
            in ? static_cast<long long>(gr) * o.k + gk + j : 0;
        cp4(sah + s + j, o.ah + off, in);
        cp4(sal + s + j, o.al + off, in);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kChunksB / kProducerThreads; ++i) {
    const int c = p + i * kProducerThreads;
    const int r = c / (kBN / 4);
    const int nc = (c % (kBN / 4)) * 4;
    const int gk = k0 + r;
    const int gn = col0 + nc;
    const int s = r * kBN + nc;
    if (o.vec_b) {  // n % 4 == 0
      const bool in = gk < o.k && gn < o.n;
      const long long off = in ? static_cast<long long>(gk) * o.n + gn : 0;
      cp16(sbh + s, o.bh + off, in);
      cp16(sbl + s, o.bl + off, in);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = gk < o.k && gn + j < o.n;
        const long long off =
            in ? static_cast<long long>(gk) * o.n + gn + j : 0;
        cp4(sbh + s + j, o.bh + off, in);
        cp4(sbl + s + j, o.bl + off, in);
      }
    }
  }
}

__device__ __forceinline__ double2 pair_sum(float h0, float h1, float l0,
                                            float l1) {
  return make_double2(static_cast<double>(h0) + static_cast<double>(l0),
                      static_cast<double>(h1) + static_cast<double>(l1));
}

// producer thread p's chunks of a staged step into the float64 tiles: each
// element (double)hi + (double)lo
__device__ __forceinline__ void compose(const float* raw, double* as,
                                        double* bs, int p) {
  const float* sah = raw;
  const float* sal = raw + kTileA;
  const float* sbh = raw + 2 * kTileA;
  const float* sbl = sbh + kTileB;
#pragma unroll
  for (int i = 0; i < kChunksA / kProducerThreads; ++i) {
    const int c = p + i * kProducerThreads;
    const int r = c >> 2;
    const int kc = (c & 3) * 4;
    const float4 h = *reinterpret_cast<const float4*>(sah + r * kBK + kc);
    const float4 l = *reinterpret_cast<const float4*>(sal + r * kBK + kc);
    *reinterpret_cast<double2*>(as + a_off(r, kc)) =
        pair_sum(h.x, h.y, l.x, l.y);
    *reinterpret_cast<double2*>(as + a_off(r, kc + 2)) =
        pair_sum(h.z, h.w, l.z, l.w);
  }
#pragma unroll
  for (int i = 0; i < kChunksB / kProducerThreads; ++i) {
    const int c = p + i * kProducerThreads;
    const int r = c / (kBN / 4);
    const int nc = (c % (kBN / 4)) * 4;
    const float4 h = *reinterpret_cast<const float4*>(sbh + r * kBN + nc);
    const float4 l = *reinterpret_cast<const float4*>(sbl + r * kBN + nc);
    *reinterpret_cast<double2*>(bs + b_off(r, nc)) =
        pair_sum(h.x, h.y, l.x, l.y);
    *reinterpret_cast<double2*>(bs + b_off(r, nc + 2)) =
        pair_sum(h.z, h.w, l.z, l.w);
  }
}

// the producer warps: stage every step through the ring, compose it into
// float64 tile s % 2 once the MMA warps are done with that tile
__device__ __forceinline__ void produce(const Operands& o, float* raw,
                                        double* as, double* bs, int row0,
                                        int col0, int steps) {
  const int p = threadIdx.x - 32 * kMmaWarps;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_stage(raw + s * kStageFloats, o, row0, col0, s * kBK, p);
    }
    cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_wait<kStages - 2>();  // this thread's copies of step s have landed
    const int b = s & 1;
    if (s >= 2) bar_sync(kEmpty + b);
    compose(raw + (s % kStages) * kStageFloats, as + b * kTileA,
            bs + b * kTileB, p);
    __threadfence_block();  // the tile's stores before the arrival
    bar_arrive(kFull + b);
    // into the slot of step s - 1, which this thread composed before
    if (s + kStages - 1 < steps) {
      load_stage(raw + ((s + kStages - 1) % kStages) * kStageFloats, o, row0,
                 col0, (s + kStages - 1) * kBK, p);
    }
    cp_commit();
  }
  cp_wait<0>();
}

// acc += the warp's patch of As Bs over one step of kBK
__device__ __forceinline__ void multiply(const double* as, const double* bs,
                                         int wm, int wn, int g, int t,
                                         double (&acc)[kMT][kNT][4]) {
#pragma unroll
  for (int k0 = 0; k0 < kBK; k0 += 4) {
    const int kk = k0 + t;
    double a[kMT][2];
    double b[kNT];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      a[mi][0] = as[a_off(wm + mi * 16 + g, kk)];
      a[mi][1] = as[a_off(wm + mi * 16 + g + 8, kk)];
    }
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) b[ni] = bs[b_off(kk, wn + ni * 8 + g)];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) mma(acc[mi][ni], a[mi], b[ni]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ds_matmul_kernel(const float* __restrict__ ah, const float* __restrict__ al,
                 const float* __restrict__ bh, const float* __restrict__ bl,
                 double* __restrict__ c, int m, int n, int k, int vec_a,
                 int vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  // float64 tile b: as + b kTileA, bs + b kTileB; then the stage ring
  double* as = reinterpret_cast<double*>(smem);
  double* bs = as + 2 * kTileA;
  float* raw = reinterpret_cast<float*>(bs + 2 * kTileB);

  const long long bz = blockIdx.z;
  const Operands o{ah + bz * m * static_cast<long long>(k),
                   al + bz * m * static_cast<long long>(k),
                   bh + bz * k * static_cast<long long>(n),
                   bl + bz * k * static_cast<long long>(n),
                   m, n, k, vec_a != 0, vec_b != 0};
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int steps = (k + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5;
  if (warp >= kMmaWarps) {
    produce(o, raw, as, bs, row0, col0, steps);
    return;
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * kWTM;  // warps 0 .. kMmaWarps - 1 multiply
  const int wn = (warp & 1) * kWTN;
  double acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0;
    }
  }
  for (int s = 0; s < steps; ++s) {
    const int b = s & 1;
    bar_sync(kFull + b);
    multiply(as + b * kTileA, bs + b * kTileB, wm, wn, g, t, acc);
    if (s + 2 < steps) bar_arrive(kEmpty + b);  // the producers' step s + 2
  }

  double* cb = c + bz * m * static_cast<long long>(n);
  const bool pairs = (n & 1) == 0;  // 16-byte aligned pairs of C
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni) {
      const int col = col0 + wn + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm + mi * 16 + g + 8 * h;
        if (row >= m || col >= n) continue;
        double* p = cb + static_cast<long long>(row) * n + col;
        const double v0 = acc[mi][ni][2 * h];
        const double v1 = acc[mi][ni][2 * h + 1];
        if (pairs) {
          *reinterpret_cast<double2*>(p) = make_double2(v0, v1);
        } else {
          p[0] = v0;
          if (col + 1 < n) p[1] = v1;
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted). Does not synchronise. ah/al: (batch, m, k), bh/bl:
// (batch, k, n), c: (batch, m, n), all contiguous. Sets the kernel's
// shared-memory attribute at the first launch on each device.
int scs_ds_matmul(const void* ah, const void* al, const void* bh,
                  const void* bl, void* c, int batch, int m, int n, int k,
                  void* stream) {
  if (batch <= 0 || m <= 0 || n <= 0) return 0;
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(ds_matmul_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const int vec_a = k % 4 == 0 && aligned16(ah) && aligned16(al);
  const int vec_b = n % 4 == 0 && aligned16(bh) && aligned16(bl);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, batch);
  ds_matmul_kernel<<<grid, kThreads, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ah), static_cast<const float*>(al),
      static_cast<const float*>(bh), static_cast<const float*>(bl),
      static_cast<double*>(c), m, n, k, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

// the build's tile: rows and columns of C per block, threads per block,
// dynamic shared memory per block in bytes
void scs_ds_matmul_tile(int* bm, int* bn, int* threads, int* smem_bytes) {
  *bm = kBM;
  *bn = kBN;
  *threads = kThreads;
  *smem_bytes = static_cast<int>(kSmemBytes);
}

const char* scs_dsmatmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
