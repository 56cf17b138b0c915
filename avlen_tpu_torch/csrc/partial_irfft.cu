// Partial inverse real FFT: out[r, :] = irfft(spec[r, :], n=N)[out_start : out_start+out_len].
//
// Replaces the TPU kernel avlen_tpu/ops/pallas_irfft.py:partial_irfft_pallas
// (body _irfft_kernel), which evaluates the same window as two dense DFT
// matmuls on the MXU.
//
// What bounds it on an H100: bytes. At the audio path's shape (32 rows of
// 32769 complex64 bins in, 32 x 16000 f32 out; N = 65536) the call must move
// ~10.4 MB, ~3 us at 3.35 TB/s, against ~0.1 GFLOP of FFT work (~1.3 us of
// f32 at 67 TFLOP/s). A dense DFT-as-matmul (~2.7 GFLOP) would be compute
// bound at ~40 us, so it is not carried over.
//
// Math. The real inverse of length N is packed into a complex inverse DFT of
// length h = N/2 (z[t] = y[2t] + i*y[2t+1]), split as h = P*Q with input
// index k = a + P*b and output index t = Q*u + v:
//   z[Q*u + v] = sum_a e^{2 pi i a u/P} * e^{2 pi i a v/h} * sum_b Z[a + P*b] e^{2 pi i b v/Q}
//
// Design: one launch; each row is a thread-block cluster of C = h/8192 CTAs
// (the plan comes from ops/irfft_cuda.py:irfft_plan), so that the whole
// transform of a row stays on chip and no intermediate goes to device memory.
// Each CTA holds 8192 values (64 KB) in one shared buffer s.
// - Pass 1, CTA c: the columns a in [c*P/C, (c+1)*P/C). The first radix stage
//   reads X[k] and X[h-k] straight from device memory (coalesced along a),
//   packs Z[k] and transforms in registers; the Q-point column FFTs end with
//   the twiddle e^{2 pi i a v/h} in s, one column after the other.
// - Cluster barrier. Pass 2, CTA c: the columns v in [c*Q/C, (c+1)*Q/C). The
//   first radix stage reads Y[v][a] for all a from the cluster's buffers
//   (distributed shared memory; each warp reads 32 consecutive v of one
//   column, 256 contiguous bytes) into registers. A second cluster barrier
//   ends all remote reads, so the stage writes its result into the CTA's own
//   s; the last stage writes the rows u that cover the window, scaled by
//   1/h, straight from registers as runs contiguous along v.
// - Column FFTs are Stockham radix-8/16 stages in registers: one block barrier
//   per stage, two where a stage transforms s in place. Buffers are
//   XOR-swizzled so that no stage, store or remote read conflicts on banks.
// - Twiddles come from shared-memory tables filled once per CTA: the Q-th
//   roots for the stages, and fine x coarse tables (padded one slot per 16)
//   for the N-th roots of the pack and of the pass-1 twiddle.
// - 256 threads of at most 128 registers and ~70 KB of shared memory let two
//   CTAs share an SM. Clusters are placed within one GPC, and with one CTA per
//   SM an H100 holds only 30 clusters of 4 (cudaOccupancyMaxActiveClusters),
//   so the audio path's 32 rows would take two waves; with two it holds 62.

#include <cuda_runtime.h>

#include "smem_fft.cuh"

using smem_fft::cmul;
using smem_fft::dft;
using smem_fft::expi;
using smem_fft::unroll;

// Launch plan; mirrored by ops/irfft_cuda.py:_CPlan and filled from irfft_plan.
struct IrfftPlan {
  int rows, h, P, Q, cluster, cols1, cols2;
  int nq, rq0, rq1, rq2, rp0, rp1;  // radices of the Q- and P-point stages
  int out_start, out_len, u0, u1;   // window; z rows u in [u0, u1] are written
  int log_fine, smem_bytes;
};

namespace {

constexpr int kThreads = 256;
constexpr int kElems = 8192;               // complex values per CTA and pass
constexpr int kVals = kElems / kThreads;   // values each thread holds in registers

// Element i of column col in a buffer of `cols` interleaved columns (column
// index fastest), XOR-swizzled so that no access pattern below conflicts.
__device__ __forceinline__ int at(int i, int col, int cols) {
  return i * cols + (col ^ (i & (cols - 1)));
}

// Element i of column col in a buffer of n-point columns stored one after
// the other (n >= 32), swizzled likewise: pass 1's layout, so that the
// remote reads of pass 2 (32 consecutive i of one column) are contiguous.
__device__ __forceinline__ int at_cm(int i, int col, int n) {
  return col * n + (i ^ (col & 31));
}

// Slot of table entry m in a table padded one slot per 16 entries.
__device__ __forceinline__ int padded(int m) { return m + (m >> 4); }

// One radix-R Stockham (decimation-in-time) stage of an n-point inverse FFT
// on `cols` columns, natural order in and out. Item (col, j), j < n/R, loads
// x[j + r*n/R], multiplies by w^{r*k} (w = e^{2 pi i/(ns*R)}, k = j mod ns),
// transforms, and stores y[(j - k)*R + k + r*ns]. Thread t holds items
// t + q*kThreads in v[q*R .. q*R+R). stage_load reads and transforms every
// item of the thread, stage_store writes them: a buffer may be transformed
// in place with a block barrier between the two. tw holds the tw_n-th roots
// of unity, ns*R dividing tw_n.
template <int R, class Load>
__device__ __forceinline__ void stage_load(float2 (&v)[kVals], int n, int ns, int cols,
                                           int log_cols, const float2* tw, int tw_n, Load load) {
  const int per = n / R;
  const int step = tw_n / (ns * R);
  unroll<0, kVals / R>([&](auto Q) {
    constexpr int q = decltype(Q)::value;
    const int it = threadIdx.x + q * kThreads;
    const int col = it & (cols - 1), j = it >> log_cols, k = j & (ns - 1);
    unroll<0, R>([&](auto I) {
      constexpr int i = decltype(I)::value;
      v[q * R + i] = load(col, j + i * per);
    });
    if (ns > 1)
      unroll<1, R>([&](auto I) {
        constexpr int i = decltype(I)::value;
        v[q * R + i] = cmul(v[q * R + i], tw[i * k * step]);
      });
    dft<R, q * R>(v);
  });
}

template <int R, class Store>
__device__ __forceinline__ void stage_store(const float2 (&v)[kVals], int ns, int cols,
                                            int log_cols, Store store) {
  unroll<0, kVals / R>([&](auto Q) {
    constexpr int q = decltype(Q)::value;
    const int it = threadIdx.x + q * kThreads;
    const int col = it & (cols - 1), j = it >> log_cols, k = j & (ns - 1);
    const int base = (j - k) * R + k;
    unroll<0, R>([&](auto I) {
      constexpr int i = decltype(I)::value;
      store(col, base + i * ns, v[q * R + i]);
    });
  });
}

// The same stage out of place: each item is loaded, transformed and stored
// in turn (a loop, so the code is not repeated for every item).
template <int R, class Load, class Store>
__device__ __forceinline__ void stage(int n, int ns, int cols, int log_cols, const float2* tw,
                                      int tw_n, Load load, Store store) {
  const int per = n / R;
  const int step = tw_n / (ns * R);
#pragma unroll 1
  for (int it = threadIdx.x; it < cols * per; it += kThreads) {
    const int col = it & (cols - 1), j = it >> log_cols, k = j & (ns - 1);
    float2 v[kVals];
    unroll<0, R>([&](auto I) {
      constexpr int i = decltype(I)::value;
      v[i] = load(col, j + i * per);
    });
    if (ns > 1)
      unroll<1, R>([&](auto I) {
        constexpr int i = decltype(I)::value;
        v[i] = cmul(v[i], tw[i * k * step]);
      });
    dft<R, 0>(v);
    const int base = (j - k) * R + k;
    unroll<0, R>([&](auto I) {
      constexpr int i = decltype(I)::value;
      store(col, base + i * ns, v[i]);
    });
  }
}

// Barrier of every thread of the cluster: arrive releases this thread's
// memory accesses, wait acquires those of all the others.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// *p in the shared memory of CTA `rank` of this cluster, p being the address
// of the same variable in this CTA (distributed shared memory).
__device__ __forceinline__ float2 load_remote(const float2* p, unsigned rank) {
  unsigned addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr) : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}

__global__ void __launch_bounds__(kThreads, 2)
    irfft_cluster(const float2* __restrict__ spec, float* __restrict__ out, const IrfftPlan p) {
  extern __shared__ float4 smem_raw[];
  // plan fields as locals: the lambdas below capture them by reference
  const int h = p.h, P = p.P, Q = p.Q, N = 2 * h, nq = p.nq;
  const int cols1 = p.cols1, cols2 = p.cols2, lc1 = __ffs(cols1) - 1, lc2 = __ffs(cols2) - 1;
  const int rp0 = p.rp0, rp1 = p.rp1, u0 = p.u0, u1 = p.u1;
  const int out_start = p.out_start, out_len = p.out_len;
  const int log_fine = p.log_fine, nfine = 1 << log_fine;

  float2* s = reinterpret_cast<float2*>(smem_raw);  // pass-1 result, then pass-2 work
  float2* twq = s + kElems;                         // e^{2 pi i j/Q}, j < Q
  float2* fine = twq + Q;                           // e^{2 pi i m/N}, m < nfine
  float2* coarse = fine + padded(nfine);            // e^{2 pi i m*nfine/N}

  const int c = blockIdx.x % p.cluster;  // rank in the row's cluster
  const int row = blockIdx.x / p.cluster;

  for (int j = threadIdx.x; j < Q; j += kThreads) twq[j] = expi(j, Q);
  for (int j = threadIdx.x; j < nfine; j += kThreads) fine[padded(j)] = expi(j, N);
  for (int j = threadIdx.x; j < (N >> log_fine); j += kThreads)
    coarse[padded(j)] = expi(j << log_fine, N);
  __syncthreads();
  auto exp_n = [&](int m) {  // e^{2 pi i m/N}, 0 <= m < N
    return cmul(fine[padded(m & (nfine - 1))], coarse[padded(m >> log_fine)]);
  };

  float2 v[kVals];

  // ---- pass 1: Q-point columns a in [a0, a0 + cols1), result in s
  const int a0 = c * cols1;
  const float2* x = spec + (size_t)row * (h + 1);
  auto load_z = [&](int col, int b) {
    const int k = a0 + col + P * b;
    float2 xk = __ldg(x + k);
    float2 xr = __ldg(x + (h - k));  // X[h-k]; X[h] (Nyquist) when k == 0
    if (k == 0) {                    // irfft reads DC and Nyquist as real
      xk.y = 0.f;
      xr.y = 0.f;
    }
    // Z[k] = 1/2 [(X[k] + conj(X[h-k])) + i e^{2 pi i k/N} (X[k] - conj(X[h-k]))]
    const float2 sum = make_float2(xk.x + xr.x, xk.y - xr.y);
    const float2 wd = cmul(exp_n(k), make_float2(xk.x - xr.x, xk.y + xr.y));
    return make_float2(0.5f * (sum.x - wd.y), 0.5f * (sum.y + wd.x));
  };
  auto load_s1 = [&](int col, int i) { return s[at_cm(i, col, Q)]; };
  int ns = 1;
  for (int st = 0; st < nq; ++st) {
    const int R = st == 0 ? p.rq0 : st == 1 ? p.rq1 : p.rq2;
    const bool last = st == nq - 1;
    auto store = [&](int col, int vv, float2 y) {
      if (last) y = cmul(y, exp_n(2 * (a0 + col) * vv));  // e^{2 pi i a v/h}
      s[at_cm(vv, col, Q)] = y;
    };
    if (st == 0) {  // reads device memory only: out of place
      if (R == 16) stage<16>(Q, ns, cols1, lc1, twq, Q, load_z, store);
      else stage<8>(Q, ns, cols1, lc1, twq, Q, load_z, store);
    } else {
      if (R == 16) stage_load<16>(v, Q, ns, cols1, lc1, twq, Q, load_s1);
      else stage_load<8>(v, Q, ns, cols1, lc1, twq, Q, load_s1);
      __syncthreads();  // every read of s done before it is overwritten
      if (R == 16) stage_store<16>(v, ns, cols1, lc1, store);
      else stage_store<8>(v, ns, cols1, lc1, store);
    }
    ns *= R;
    if (!last) __syncthreads();
  }
  cluster_sync();  // every CTA's s complete and visible to the cluster

  // ---- pass 2: P-point columns v in [v0, v0 + cols2)
  const int v0 = c * cols2;
  auto load_y = [&](int col, int a) {  // Y[v][a] lives in CTA a / cols1
    return load_remote(s + at_cm(v0 + col, a & (cols1 - 1), Q), (unsigned)(a >> lc1));
  };
  auto store_s2 = [&](int col, int a, float2 y) { s[at(a, col, cols2)] = y; };
  if (rp0 == 16) stage_load<16>(v, P, 1, cols2, lc2, twq, Q, load_y);
  else stage_load<8>(v, P, 1, cols2, lc2, twq, Q, load_y);
  cluster_sync();  // no CTA reads another's s after this, so s is free
  if (rp0 == 16) stage_store<16>(v, 1, cols2, lc2, store_s2);
  else stage_store<8>(v, 1, cols2, lc2, store_s2);
  __syncthreads();

  const float inv_h = 1.0f / (float)h;
  float* o = out + (size_t)row * out_len;
  const bool even_row = (((size_t)row * out_len) & 1) == 0;
  auto load_s2 = [&](int col, int i) { return s[at(i, col, cols2)]; };
  auto store_out = [&](int col, int u, float2 z) {  // y[2t] = Re z[t], y[2t+1] = Im z[t]
    if (u < u0 || u > u1) return;
    const int n = 2 * (Q * u + v0 + col) - out_start;
    const float re = z.x * inv_h, im = z.y * inv_h;
    if (n >= 0 && n + 1 < out_len && even_row == ((n & 1) == 0)) {
      *reinterpret_cast<float2*>(o + n) = make_float2(re, im);
    } else {
      if (n >= 0 && n < out_len) o[n] = re;
      if (n + 1 >= 0 && n + 1 < out_len) o[n + 1] = im;
    }
  };
  if (rp1 == 16) stage<16>(P, rp0, cols2, lc2, twq, Q, load_s2, store_out);
  else stage<8>(P, rp0, cols2, lc2, twq, Q, load_s2, store_out);
}

int g_smem_attr = 0;  // dynamic shared memory the kernel is allowed so far

}  // namespace

// Sets the kernel's attributes (dynamic shared memory up to smem_bytes,
// non-portable cluster sizes) the first time they are needed, then returns
// cudaOccupancyMaxActiveClusters for clusters of `cluster` CTAs of
// `threads` threads and smem_bytes each, or minus the CUDA error.
extern "C" int partial_irfft_max_clusters(int cluster, int smem_bytes, int threads) {
  cudaError_t e = cudaSuccess;
  if (smem_bytes > g_smem_attr) {
    e = cudaFuncSetAttribute(irfft_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(irfft_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return -(int)e;
    }
    g_smem_attr = smem_bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, irfft_cluster, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return n;
}

// spec: (rows, h+1) complex64; out: (rows, out_len) f32. One launch of
// rows clusters on `stream`; partial_irfft_max_clusters must have been called
// for the plan's smem_bytes first. Returns the launch's CUDA error.
extern "C" int partial_irfft(const void* spec, void* out, const IrfftPlan* plan, void* stream) {
  if (plan->h != plan->cluster * kElems || plan->P * plan->Q != plan->h)
    return (int)cudaErrorInvalidValue;  // a plan made for another kElems
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan->cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(plan->cluster * plan->rows, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan->smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, irfft_cluster, static_cast<const float2*>(spec),
                                           static_cast<float*>(out), *plan);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
