// Log-mean-pooled magnitude spectrogram of binaural audio, framing included:
//   audio (B, 2, T) f32 -> out (B, F', T', 2) f32, channel-last, where
//   reflect-pad n_fft/2 -> frames of n_fft at hop -> centred periodic Hann
//   window -> |DFT| over n_fft/2+1 bins -> bf x bt mean pool with the zero
//   padding counted -> log1p.
//
// Replaces the TPU kernel avlen_tpu/ops/pallas_spectrogram.py:spectrogram_pallas
// (body _kernel). There the framing ran outside the kernel as an XLA gather,
// only because Mosaic needs 128-aligned slices and hop 160 is not; here each
// block frames its own samples, reflect pad included.
//
// What bounds it on an H100: at the rollout's 16 envs of 16 kHz audio,
// bytes, ~2.3 MB (~0.7 us at 3.35 TB/s), far under what one block's chain
// of dependent steps (load, stages, pool, store) and the ~2 us launch take,
// so that chain is what the design shortens. It is not launch overhead: a
// radix-2 shared-memory design of the same function (one block per ear and
// pooled column, nine barriers) took 40.5 us there on an H100 at 700 W, 95 %
// of it inside its blocks and 70 % in its radix-2 stages. At the
// spectrogram bank's 256 rows a call moves ~36 MB (~11 us) and does
// ~0.6 GFLOP (~9 us of f32): there the instructions and shared-memory
// traffic inside the blocks decide the time.
//
// Design (launch plan: ops/spectrogram_cuda.py:spectrogram_plan; one launch):
// - One block per (env, pooled time column), bt frames of both ears.
// - Both ears in one complex FFT: z[n] = w[n] (x_L[p] + i x_R[p]) gives
//   X_L[k] = (Z[k] + conj Z[N-k]) / 2 and X_R[k] = (Z[k] - conj Z[N-k]) / 2i,
//   half the transforms of one FFT per ear. |X| is the same under either
//   transform sign, so the inverse (+) DFT of smem_fft.cuh serves.
// - Framing once per block: the (bt-1)*hop + N consecutive padded samples of
//   both ears are read coalesced, reflected at the edges, into shared memory
//   as (left, right) pairs; each thread windows its stage-one inputs there.
// - N is a template parameter, so all index math is shifts and masks.
//   Radix-8 Stockham stages in registers (a radix-2 or radix-4 stage first
//   where log2 N is not a multiple of 3): N/8 threads a frame, 8 values a
//   thread; between stages one exchange through one of two shared buffers,
//   frames at a stride of N, XOR-swizzled so that no stage's loads or
//   stores conflict on banks (for N >= 128) at one LOP3 an access; the last
//   stage's result in natural order at a stride of N + 1, where pooling
//   reads it without conflicts; one barrier a stage, three for N = 512.
//   Twiddles come from one table of the N-th roots per device (float64 on
//   the host, rounded), read with __ldg before the span: w, w^2 and w^4 of
//   each stage, the other powers as products. No sincos runs in a block.
// - Pooling on every thread: each lane sums the bf magnitudes of one pooled
//   bin in one frame for both ears, a group of bt lanes (a power of two)
//   adds its frames with warp shuffles, the sum is divided by bf*bt always
//   (the zero padding counts in the mean), and one float2 store writes
//   log1p of both ears.

#include <cuda_runtime.h>

#include "smem_fft.cuh"

using smem_fft::cmul;
using smem_fft::dft;
using smem_fft::unroll;

namespace {

constexpr int kValues = 8;  // complex values a thread holds through every stage
constexpr int kMaxThreads = 1024;

// The launch for (n_fft, hop, bt); mirrored by spectrogram_plan.
struct Launch {
  int threads, span, buffer_slots, smem_bytes, group;
};

Launch launch_of(int n_fft, int hop, int bt) {
  Launch l;
  l.threads = (bt * n_fft / kValues + 31) / 32 * 32;
  l.span = (bt - 1) * hop + n_fft;
  l.buffer_slots = bt * (n_fft + 1) > l.span ? bt * (n_fft + 1) : l.span;
  l.smem_bytes = 2 * l.buffer_slots * (int)sizeof(float2);
  int g = 2;  // lanes 0 and 1 of a group take one ear each
  while (g < bt && g < 32) g <<= 1;
  l.group = g;
  return l;
}

__host__ __device__ constexpr int radix_at(int log_n, int s) {  // radix of stage s
  return (log_n % 3 != 0 && s == 0) ? 1 << (log_n % 3) : 8;
}

__host__ __device__ constexpr int num_stages(int log_n) { return log_n / 3 + (log_n % 3 != 0); }

__host__ __device__ constexpr int span_before(int log_n, int s) {  // product of the radices before stage s
  int ns = 1;
  for (int i = 0; i < s; ++i) ns *= radix_at(log_n, i);
  return ns;
}

// Slot of element i of a frame in an exchange buffer: bits 0-3 XORed with
// (k << 1 | parity(k)), k = bits 4-6 (ops/spectrogram_cuda.py:SWIZZLE). The
// map is linear over bits, so swz(a | b) = swz(a) ^ swz(b) for a and b with
// no bit in common: a stage computes swz of each item's base once and XORs
// in the constant swz of each value's offset.
__host__ __device__ constexpr int swz(int i) {
  const int k = (i >> 4) & 7;
  return i ^ ((k << 1) | (((k >> 2) ^ (k >> 1) ^ k) & 1));
}

// sqrt.approx: one instruction, relative error below 2^-22 (the magnitudes
// are summed and go through log1p; the tolerance is 1e-4 absolute).
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// w^1 .. w^(R-1) of a stage's twiddle w from its powers of two w, w^2,
// w^4 (read from the table): the rest as products.
template <int R>
__device__ __forceinline__ void twiddle_powers(const float2 (&pow2)[3], float2 (&w)[R]) {
  unroll<1, R>([&](auto I) {
    constexpr int r = decltype(I)::value, low = r & -r;
    if constexpr (low == r) w[r] = pow2[r == 1 ? 0 : r == 2 ? 1 : 2];
    else w[r] = cmul(w[r - low], w[low]);
  });
}

template <int LOG_N>
__global__ void __launch_bounds__(kMaxThreads)
    spectrogram_kernel(const float* __restrict__ audio, const float* __restrict__ window,
                       const float2* __restrict__ twiddles, float* __restrict__ out, int T, int hop,
                       int n_frames, int bf, int bt, int fprime, int tprime, int span,
                       int buffer_slots, int log_group) {
  constexpr int N = 1 << LOG_N, TPF = N / kValues;
  constexpr int ZSTRIDE = N + 1;  // the last stage's frames: natural order
  constexpr int STAGES = num_stages(LOG_N);
  extern __shared__ float2 smem[];
  float2* const buf0 = smem;
  float2* const buf1 = smem + buffer_slots;  // the span until stage 1 writes it
  const int b = blockIdx.y, col = blockIdx.x;
  const int frames = min(bt, n_frames - col * bt);  // frames of the block below n_frames

  const int f = threadIdx.x >> (LOG_N - 3);  // this thread's frame
  const int t = threadIdx.x & (TPF - 1);
  const bool active = f < frames;

  // Loads that the span's latency hides: stage one's window values, and
  // w, w^2, w^4 of every later stage (radix 8, one item a thread).
  constexpr int R0 = radix_at(LOG_N, 0);
  float win[kValues];
  float2 tw[STAGES][3];
  if (active) {
    unroll<0, kValues>([&](auto I) {
      constexpr int i = decltype(I)::value;  // value r of item q
      win[i] = __ldg(window + t + (i / R0) * TPF + (i % R0) * (N / R0));
    });
    unroll<1, STAGES>([&](auto S) {
      constexpr int s = decltype(S)::value, NS = span_before(LOG_N, s);
      static_assert(radix_at(LOG_N, s) == 8, "stages after the first are radix 8");
      const int m = (t & (NS - 1)) * (N / (NS * 8));
      unroll<0, 3>([&](auto B) {
        constexpr int e = decltype(B)::value;
        tw[s][e] = __ldg(twiddles + (m << e));
      });
    });
  }

  {  // span: padded samples q0 .. q0+span-1 of both ears, as (left, right)
    constexpr int kBatch = 4;  // loads in flight per thread
    const float* xl = audio + (size_t)b * 2 * T;
    const float* xr = xl + T;
    const int q0 = col * bt * hop, pad = N / 2;
    for (int s0 = threadIdx.x; s0 < span; s0 += kBatch * blockDim.x) {
      float2 x[kBatch];
      unroll<0, kBatch>([&](auto I) {
        const int s = s0 + decltype(I)::value * blockDim.x, q = q0 + s;
        x[decltype(I)::value] = make_float2(0.f, 0.f);
        if (s < span && q < T + 2 * pad) {
          int p = q - pad;                  // index into the unpadded signal
          if (p < 0) p = -p;                // reflect (edge sample not repeated)
          if (p >= T) p = 2 * (T - 1) - p;
          x[decltype(I)::value] = make_float2(__ldg(xl + p), __ldg(xr + p));
        }
      });
      unroll<0, kBatch>([&](auto I) {
        const int s = s0 + decltype(I)::value * blockDim.x;
        if (s < span) buf1[s] = x[decltype(I)::value];
      });
    }
  }
  __syncthreads();

  float2 v[kValues];
  // Stage s, radix R, after NS points: item j < N/R loads x[j + r*N/R],
  // multiplies by e^{2 pi i r k/(NS R)} (k = j mod NS), transforms and
  // stores y[(j - k) R + k + r NS]; thread t holds items t + q*N/8.
  unroll<0, STAGES>([&](auto S) {
    constexpr int s = decltype(S)::value;
    constexpr int R = radix_at(LOG_N, s), NS = span_before(LOG_N, s), PER = N / R;
    constexpr bool last = s == STAGES - 1;
    if (active) {
      // exchange buffers hold frame f at f*N, so that f*N + (swz(i) ^ c) =
      // (f*N + swz(i)) ^ c: one XOR an access
      const float2* in = (s & 1) ? buf0 : buf1;
      float2* o = (s & 1) ? buf1 : buf0;
      unroll<0, kValues / R>([&](auto Q) {
        constexpr int q = decltype(Q)::value;
        const int j = t + q * TPF, k = j & (NS - 1);
        const int sj = f * N + swz(j);
        unroll<0, R>([&](auto I) {
          constexpr int r = decltype(I)::value;
          if constexpr (s == 0) {
            const float2 x = in[f * hop + j + r * PER];
            v[q * R + r] = make_float2(win[q * R + r] * x.x, win[q * R + r] * x.y);
          } else {
            v[q * R + r] = in[sj ^ swz(r * PER)];
          }
        });
        if constexpr (NS > 1) {
          float2 w[R];
          twiddle_powers<R>(tw[s], w);
          unroll<1, R>([&](auto I) {
            constexpr int r = decltype(I)::value;
            v[q * R + r] = cmul(v[q * R + r], w[r]);
          });
        }
        dft<R, q * R>(v);
        const int base = (j - k) * R + k;
        const int sb = f * N + swz(base);
        unroll<0, R>([&](auto I) {
          constexpr int r = decltype(I)::value;
          if constexpr (last) o[f * ZSTRIDE + base + r * NS] = v[q * R + r];
          else o[sb ^ swz(r * NS)] = v[q * R + r];
        });
      });
    }
    __syncthreads();
  });

  // Pooling: lane l of a group of 2^log_group lanes sums the bf bins of
  // pooled bin jf in frames l, l + group, ...; the group's shuffles add the
  // frames, and lanes 0 and 1 take log1p of the left and right sums. Every
  // warp makes the passes it has work in.
  const float2* z = (STAGES & 1) ? buf0 : buf1;  // Z of each frame, natural order
  const int group = 1 << log_group;
  const int lane = threadIdx.x & (group - 1);
  const int per_pass = blockDim.x >> log_group;
  const float scale = 0.5f / (float)(bf * bt);
  for (int j0 = 0; j0 + ((threadIdx.x & ~31) >> log_group) < fprime; j0 += per_pass) {
    const int jf = j0 + (threadIdx.x >> log_group);
    float sl = 0.f, sr = 0.f;
    if (jf < fprime) {
      const int k0 = jf * bf, k1 = min(k0 + bf, N / 2 + 1);
      for (int fr = lane; fr < frames; fr += group) {
        const float2* zf = z + fr * ZSTRIDE;
#pragma unroll 4
        for (int k = k0; k < k1; ++k) {
          const float2 a = zf[k], c = zf[(N - k) & (N - 1)];
          const float lx = a.x + c.x, ly = a.y - c.y;  // 2 X_L[k]
          const float rx = a.x - c.x, ry = a.y + c.y;  // 2i X_R[k]
          const float ml = lx * lx + ly * ly, mr = rx * rx + ry * ry;
          sl += sqrt_approx(ml);
          sr += sqrt_approx(mr);
        }
      }
    }
    for (int o = group >> 1; o > 0; o >>= 1) {
      sl += __shfl_xor_sync(0xffffffffu, sl, o);
      sr += __shfl_xor_sync(0xffffffffu, sr, o);
    }
    const float lg = log1pf(((lane & 1) ? sr : sl) * scale);
    const float lg_r = __shfl_down_sync(0xffffffffu, lg, 1);
    if (jf < fprime && lane == 0)
      *reinterpret_cast<float2*>(out + (((size_t)b * fprime + jf) * tprime + col) * 2) =
          make_float2(lg, lg_r);
  }
}

template <int LOG_N>
int run(const float* audio, const float* window, const float2* twiddles, float* out, int batch,
        int T, int hop, int n_frames, int bf, int bt, int fprime, int tprime, const Launch& l,
        cudaStream_t stream) {
  static int smem_attr = 48 * 1024;  // dynamic shared memory allowed so far
  if (l.smem_bytes > smem_attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        spectrogram_kernel<LOG_N>, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    smem_attr = l.smem_bytes;
  }
  int log_group = 0;
  while ((1 << log_group) < l.group) ++log_group;
  spectrogram_kernel<LOG_N><<<dim3(tprime, batch), l.threads, l.smem_bytes, stream>>>(
      audio, window, twiddles, out, T, hop, n_frames, bf, bt, fprime, tprime, l.span,
      l.buffer_slots, log_group);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch for these settings: threads, span, buffer slots, shared bytes,
// group (ops/spectrogram_cuda.py checks it against spectrogram_plan).
// Returns 0.
extern "C" int spectrogram_launch_info(int n_fft, int hop, int bt, int* info) {
  const Launch l = launch_of(n_fft, hop, bt);
  const int fields[5] = {l.threads, l.span, l.buffer_slots, l.smem_bytes, l.group};
  for (int i = 0; i < 5; ++i) info[i] = fields[i];
  return 0;
}

// audio: (batch, 2, T) f32; window: (n_fft,) f32; twiddles: (n_fft,) float2,
// e^{+2 pi i m/n_fft}; out: (batch, fprime, tprime, 2) f32. n_fft a power of
// two in [64, 1024]. Launches on `stream`; returns the launch's CUDA error.
extern "C" int spectrogram(const float* audio, const float* window, const void* twiddles, float* out,
                           int batch, int T, int n_fft, int hop, int n_frames, int bf, int bt,
                           int fprime, int tprime, void* stream) {
  const Launch l = launch_of(n_fft, hop, bt);
  if (l.threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const float2* tw = static_cast<const float2*>(twiddles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_fft) {
    case 64: return run<6>(audio, window, tw, out, batch, T, hop, n_frames, bf, bt, fprime, tprime, l, st);
    case 128: return run<7>(audio, window, tw, out, batch, T, hop, n_frames, bf, bt, fprime, tprime, l, st);
    case 256: return run<8>(audio, window, tw, out, batch, T, hop, n_frames, bf, bt, fprime, tprime, l, st);
    case 512: return run<9>(audio, window, tw, out, batch, T, hop, n_frames, bf, bt, fprime, tprime, l, st);
    case 1024: return run<10>(audio, window, tw, out, batch, T, hop, n_frames, bf, bt, fprime, tprime, l, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
