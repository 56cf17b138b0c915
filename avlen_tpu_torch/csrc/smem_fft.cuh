// FFT building blocks shared by partial_irfft.cu and spectrogram.cu: complex
// products, roots of unity, and unnormalised inverse DFTs of 2, 4, 8 or 16
// points held in registers.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace smem_fft {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// e^{+2*pi*i*num/den}; exact arguments for power-of-two den and num < 2^24.
__device__ __forceinline__ float2 expi(int num, int den) {
  float s, c;
  sincospif(2.0f * (float)num / (float)den, &s, &c);
  return make_float2(c, s);
}

// Calls f(std::integral_constant<int, i>) for i in [B, E): indices that the
// compiler sees as constants, so that register arrays stay in registers.
template <int B, int E, class F>
__device__ __forceinline__ void unroll(F&& f) {
  if constexpr (B < E) {
    f(std::integral_constant<int, B>{});
    unroll<B + 1, E>(f);
  }
}

__host__ __device__ constexpr float cos_pi8(int r) {  // cos(r*pi/8), 0 <= r <= 4
  return r == 0 ? 1.f : r == 1 ? 0.92387953251f : r == 2 ? 0.70710678119f
                                 : r == 3 ? 0.38268343237f : 0.f;
}

// b * e^{+2 pi i M/16}
template <int M>
__device__ __forceinline__ float2 rot16(float2 b) {
  constexpr int r = M & 3, q = (M >> 2) & 3;
  if constexpr (r == 0) {
    if constexpr (q == 0) return b;
    if constexpr (q == 1) return make_float2(-b.y, b.x);
    if constexpr (q == 2) return make_float2(-b.x, -b.y);
    return make_float2(b.y, -b.x);
  } else {
    constexpr float c = cos_pi8(r), sn = cos_pi8(4 - r);
    const float2 w = q == 0 ? make_float2(c, sn) : q == 1 ? make_float2(-sn, c)
                   : q == 2 ? make_float2(-c, -sn) : make_float2(sn, -c);
    return cmul(w, b);
  }
}

__host__ __device__ constexpr int bitrev_c(int i, int bits) {
  int j = 0;
  for (int b = 0; b < bits; ++b) j |= ((i >> b) & 1) << (bits - 1 - b);
  return j;
}

// In-register unnormalised inverse DFT of v[OFF .. OFF+R), R = 2, 4, 8 or
// 16, natural order in and out (radix-2 decimation in time).
template <int R, int OFF, int NV>
__device__ __forceinline__ void dft(float2 (&v)[NV]) {
  static_assert(R == 2 || R == 4 || R == 8 || R == 16, "dft: R must be 2, 4, 8 or 16");
  static_assert(OFF + R <= NV, "dft: past the register array");
  constexpr int L = R == 16 ? 4 : R == 8 ? 3 : R == 4 ? 2 : 1;
  unroll<0, R>([&](auto I) {
    constexpr int i = decltype(I)::value, j = bitrev_c(i, L);
    if constexpr (j > i) {
      const float2 t = v[OFF + i];
      v[OFF + i] = v[OFF + j];
      v[OFF + j] = t;
    }
  });
  unroll<1, L + 1>([&](auto S) {
    constexpr int len = 1 << decltype(S)::value;
    unroll<0, R / len>([&](auto G) {
      unroll<0, len / 2>([&](auto K) {
        constexpr int k = decltype(K)::value;
        constexpr int i0 = OFF + decltype(G)::value * len + k, i1 = i0 + len / 2;
        const float2 a = v[i0], b = rot16<k * (16 / len)>(v[i1]);
        v[i0] = make_float2(a.x + b.x, a.y + b.y);
        v[i1] = make_float2(a.x - b.x, a.y - b.y);
      });
    });
  });
}

}  // namespace smem_fft
