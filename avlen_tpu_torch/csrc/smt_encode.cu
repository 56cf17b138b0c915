// The whole 1-encoder / 1-decoder Scene Memory Transformer encode, f32:
//   entries (B, L, F), valid (B, L), goal (B, D) or none  ->  out (B, D)
// fusion MLP F->D->D (ReLU); encoder layer: masked multi-head self-attention
// (additive -1e9), residual + LayerNorm, FFN D->D->D (ReLU), residual +
// LayerNorm; single-query decoder: its self-attention over one key collapses
// to out(v(tgt)), then masked cross-attention over the L encoder rows,
// residual + LayerNorm, FFN, residual + LayerNorm. The query is the goal, or
// encoder row L-1 when there is none. LayerNorm eps is 1e-6 (Flax's).
//
// Replaces the TPU kernel avlen_tpu/ops/pallas_smt.py:smt_encode
// (_fused_forward -> pallas_call, body _kernel).
//
// What bounds it on an H100: operations. At the rollout shape (B=16, L=151,
// F=288, D=256, 8 heads of 32) one call is ~3.6 GFLOP against ~6.5 MB of
// inputs and weights. In f32 on the CUDA cores that is ~54 us at 67 TFLOP/s.
// The products here run on the tensor cores in 3xTF32: each f32 operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), and a*b is accumulated in
// f32 as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, which keeps about f32 accuracy
// (plain TF32 keeps ~3 digits and would miss the 1e-4 tolerance). That is
// three times the work at 495 TFLOP/s: ~22 us. The products of each 32-wide
// K slice are summed in fresh registers and added to the running sums with
// f32 adds, since the tensor cores' own accumulation truncates.
//
// Design: six launches from one C entry, on one stream, each sized by
// plan_make (mirrored by ops/smt_cuda.py:smt_plan):
//   1 fusion MLP        entries -> h; both GEMMs in one block, the BM x D
//                       ReLU intermediate in shared memory
//   2 QKV projection    h -> q, k, v; grid.y picks the weight (no copy)
//   3 self-attention    tensor-core QK^T and PV, online softmax, K/V tiles of
//                       64 keys double-buffered; grid (query tile, head, row)
//   4 out-projection    ctx -> + bias + residual h -> LayerNorm_0 -> x1
//   5 FFN + cross K/V   x1 -> FFN -> + residual -> LayerNorm_1 (= the
//                       encoder output), then its cross-attention K and V
//                       projections from the same rows in shared memory
//   6 decoder           a cluster of 8 CTAs per batch row: every one-row
//                       product as an f32 matrix-vector product, each CTA an
//                       eighth of its outputs, shared over distributed
//                       shared memory; single-query attention
// Launches 1, 2, 4 and 5 are "row blocks": a block of BM rows and D/32 warps
// (each owning 32 output columns; twice that in 1, 4 and 5 at BM <= 32, the
// two groups splitting each K slice) streams the weight (PyTorch's (out, in)
// layout, which is the .col operand of mma) through shared memory in K
// slices of 32 with cp.async, two or three slices in flight, so weights are
// never transposed or copied. Shared rows are padded to a stride = 4
// (mod 32) floats, which makes the fragment reads (row = lane/4, col =
// lane%4) conflict-free. Attention loops over exactly L keys (padded keys
// get -inf, i.e. weight 0), and masked keys add -1e9 (never -inf), so a
// fully masked row stays finite, as in the reference.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smt_ptx.cuh"

namespace {

constexpr float kNegInf = -1e9f;
constexpr float kLnEps = 1e-6f;
constexpr int kSMs = 132;           // H100 SXM
constexpr int kMaxSmem = 232448;    // bytes one block may use on an H100
constexpr int kBK = 32;             // K slice of a staged tile
constexpr int kStagesRows = 3;      // staged slices of the row blocks that keep BM x D rows
constexpr int kStagesProj = 2;      // of the QKV blocks (smaller, two fit an SM)
constexpr int kPadK = kBK + 4;      // its row stride in shared memory
constexpr int kQTile = 64;          // queries of one attention block (4 warps x 16)
constexpr int kKTile = 64;          // keys of one staged K/V tile
constexpr int kAttnThreads = 128;
constexpr int kTailThreads = 256;
constexpr int kTailCluster = 8;    // CTAs of one batch row's decoder (the portable maximum)
constexpr int kNumLaunches = 6;

// Warp groups that split each K slice of the row blocks that keep BM x D
// rows (fusion, out_ln, ffn_kv): two (twice the warps an SM has to hide
// latency with) where the accumulators leave room under the 128 registers
// of 512 threads; one at BM = 64, and always one in the QKV blocks, two of
// which share an SM.
__host__ __device__ constexpr int k_groups(int mt) { return mt == 4 ? 1 : 2; }

// ---------------------------------------------------------------------------
// 3xTF32 building blocks
// ---------------------------------------------------------------------------
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = cvt_tf32(x);
  lo = cvt_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Row-block GEMM: acc (BM x 32 per warp) = A[BM, K] @ W[warp's 32 of D, K]^T.
// The block has KG x D/32 warps; group kg multiplies its share of each
// staged K slice.
// A streams from global (rows, row stride lda; rows past `rows` read as 0)
// or is resident in shared memory (As, row stride lds, K = its width).
// Stage layout: [W: D x kPadK][A: BM x kPadK], NST stages.
// Fragment (mt, nt, i) is row mt*16 + g + 8*(i/2), column warp*32 + nt*8 +
// 2t + i%2.
// ---------------------------------------------------------------------------
template <int MT, bool kAStream, bool kVec>
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ W, int K, int D,
                                           const float* __restrict__ A, int lda, int rows, int kt) {
  const int k0 = kt * kBK;
  float* as = st + D * kPadK;
  if (kVec) {  // K % 4 == 0 and 16-byte aligned rows: whole 16-byte chunks
    for (int i = threadIdx.x; i < D * (kBK / 4); i += blockDim.x) {
      const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
      const bool ok = k0 + c < K;
      cp_async16(st + r * kPadK + c, ok ? W + (size_t)r * K + k0 + c : W, ok);
    }
    if (kAStream)
      for (int i = threadIdx.x; i < MT * 16 * (kBK / 4); i += blockDim.x) {
        const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
        const bool ok = r < rows && k0 + c < K;
        cp_async16(as + r * kPadK + c, ok ? A + (size_t)r * lda + k0 + c : A, ok);
      }
  } else {
    for (int i = threadIdx.x; i < D * kBK; i += blockDim.x) {
      const int r = i / kBK, c = i % kBK;
      const bool ok = k0 + c < K;
      cp_async4(st + r * kPadK + c, ok ? W + (size_t)r * K + k0 + c : W, ok);
    }
    if (kAStream)
      for (int i = threadIdx.x; i < MT * 16 * kBK; i += blockDim.x) {
        const int r = i / kBK, c = i % kBK;
        const bool ok = r < rows && k0 + c < K;
        cp_async4(as + r * kPadK + c, ok ? A + (size_t)r * lda + k0 + c : A, ok);
      }
  }
}

template <int MT, int NST, int KG, bool kAStream, bool kVec>
__device__ __forceinline__ void gemm_rows(float (&acc)[MT][4][4], const float* __restrict__ A, int lda,
                                          int rows, const float* As, int lds,
                                          const float* __restrict__ W, int K, int D, float* stage) {
  constexpr int KSG = kBK / 8 / KG;  // k8 steps of a slice for each group
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int nwc = D / 32, wcol = warp % nwc, kg = warp / nwc;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  const int stage_floats = (D + MT * 16) * kPadK;
  const int nk = (K + kBK - 1) / kBK;
  // NST-1 slices in flight ahead of the one being multiplied; one commit
  // group per slice (empty past the end), so wait<NST-1> means slice kt landed
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nk) load_stage<MT, kAStream, kVec>(stage + s * stage_floats, W, K, D, A, lda, rows, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const float* cur = stage + (kt % NST) * stage_floats;
    if (kt + NST - 1 < nk)
      load_stage<MT, kAStream, kVec>(stage + ((kt + NST - 1) % NST) * stage_floats, W, K, D, A, lda,
                                     rows, kt + NST - 1);
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncthreads();
    // this slice's products go to fresh registers, added to acc below with
    // f32 adds (round to nearest): the tensor cores' own accumulation
    // truncates, and over a whole K its bias grows past the tolerance's margin
    float part[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
    const float* ws = cur + (wcol * 32 + g) * kPadK + t;
    const int sa = kAStream ? kPadK : lds;
    const float* as = kAStream ? cur + D * kPadK + g * kPadK + t : As + g * lds + kt * kBK + t;
#pragma unroll
    for (int kk = 0; kk < KSG; ++kk) {
      const int ks = kg * KSG + kk;
      uint32_t ah[MT][4], al[MT][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* p = as + mt * 16 * sa + ks * 8;
        split_tf32(p[0], ah[mt][0], al[mt][0]);
        split_tf32(p[8 * sa], ah[mt][1], al[mt][1]);
        split_tf32(p[4], ah[mt][2], al[mt][2]);
        split_tf32(p[8 * sa + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* q = ws + nt * 8 * kPadK + ks * 8;
        split_tf32(q[0], bh[nt][0], bl[nt][0]);
        split_tf32(q[4], bh[nt][1], bl[nt][1]);
      }
      // three passes over the 4*MT independent accumulators, so that no
      // product waits on the one before it
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32_16x8x8(part[mt][nt], al[mt], bh[nt]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32_16x8x8(part[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_tf32_16x8x8(part[mt][nt], ah[mt], bh[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    __syncthreads();  // every warp is done with `cur` before it is refilled
  }
  if (KG > 1) {  // group 0 adds group 1's partial sums, through the free stages
    const int n = nwc * 32, tg = threadIdx.x % n;
    int i = 0;
    if (kg == 1)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) stage[(i++) * n + tg] = acc[mt][nt][j];
    __syncthreads();
    i = 0;
    if (kg == 0)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mt][nt][j] += stage[(i++) * n + tg];
    __syncthreads();
  }
}

// Calls f(row, col, v) for each pair of accumulators of this thread: v.x at
// (row, col), v.y at (row, col + 1), col even; the warps of k-group 0 hold
// the sums.
template <int MT, typename Fn>
__device__ __forceinline__ void for_acc(const float (&acc)[MT][4][4], int D, Fn f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  if (warp >= D / 32) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(mt * 16 + g + 8 * h, warp * 32 + nt * 8 + 2 * t,
          make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]));
}

__device__ __forceinline__ void st2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// Mean and 1/std of one row of D values in shared memory, by one warp.
__device__ __forceinline__ void row_stats(const float* x, int D, float& mean, float& inv) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s += x[i];
  mean = warp_sum(s) / (float)D;
  float v = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float d = x[i] - mean;
    v = fmaf(d, d, v);
  }
  inv = 1.0f / sqrtf(warp_sum(v) / (float)D + kLnEps);
}

// ---------------------------------------------------------------------------
// launch 1: h = relu(X W0^T + b0) W1^T + b1
// ---------------------------------------------------------------------------
template <int MT, bool kVec>
__global__ void __launch_bounds__(32 * k_groups(MT) * 8, 1) smt_fusion(const float* __restrict__ X,
                                                  const float* __restrict__ W0,
                                                  const float* __restrict__ b0,
                                                  const float* __restrict__ W1,
                                                  const float* __restrict__ b1,
                                                  float* __restrict__ Hout, int M, int F, int D) {
  extern __shared__ __align__(16) float smem[];
  const int ldt = D + 4;
  float* T = smem;
  float* stage = T + MT * 16 * ldt;
  const int m0 = blockIdx.x * MT * 16;
  const int rows = min(MT * 16, M - m0);
  float acc[MT][4][4];
  gemm_rows<MT, kStagesRows, k_groups(MT), true, kVec>(acc, X + (size_t)m0 * F, F, rows, nullptr, 0,
                                                       W0, F, D, stage);
  for_acc(acc, D, [&](int r, int c, float2 v) {
    const float2 b = ld2(b0 + c);
    st2(T + r * ldt + c, make_float2(fmaxf(v.x + b.x, 0.f), fmaxf(v.y + b.y, 0.f)));
  });
  __syncthreads();
  gemm_rows<MT, kStagesRows, k_groups(MT), false, true>(acc, nullptr, 0, 0, T, ldt, W1, D, D, stage);
  for_acc(acc, D, [&](int r, int c, float2 v) {
    const float2 b = ld2(b1 + c);
    if (r < rows) st2(Hout + (size_t)(m0 + r) * D + c, make_float2(v.x + b.x, v.y + b.y));
  });
}

// ---------------------------------------------------------------------------
// launch 2: out[s] = X W[s]^T + b[s] for the segment s = blockIdx.y
// ---------------------------------------------------------------------------
struct ProjArgs {
  const float* w[3];
  const float* b[3];
  float* out[3];
};

template <int MT>
__global__ void __launch_bounds__(256) smt_proj(const float* __restrict__ X, ProjArgs p, int M,
                                                int D) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.y;
  const int m0 = blockIdx.x * MT * 16;
  const int rows = min(MT * 16, M - m0);
  // selects, not an indexed parameter, so the arguments stay out of local memory
  const float* __restrict__ W = s == 0 ? p.w[0] : s == 1 ? p.w[1] : p.w[2];
  const float* __restrict__ bias = s == 0 ? p.b[0] : s == 1 ? p.b[1] : p.b[2];
  float* __restrict__ out = s == 0 ? p.out[0] : s == 1 ? p.out[1] : p.out[2];
  float acc[MT][4][4];
  gemm_rows<MT, kStagesProj, 1, true, true>(acc, X + (size_t)m0 * D, D, rows, nullptr, 0, W, D, D, smem);
  for_acc(acc, D, [&](int r, int c, float2 v) {
    const float2 b = ld2(bias + c);
    if (r < rows) st2(out + (size_t)(m0 + r) * D + c, make_float2(v.x + b.x, v.y + b.y));
  });
}

// ---------------------------------------------------------------------------
// launch 3: masked self-attention, O = softmax(Q K^T / sqrt(dh) + mask) V per
// head. Block (query tile, head, batch row), 4 warps of 16 queries each.
// Q/K/V/O: (B, L, D), head h at columns [h*DH, (h+1)*DH).
// ---------------------------------------------------------------------------
template <int DH>
__global__ void __launch_bounds__(kAttnThreads) smt_attn(const float* __restrict__ Q,
                                                         const float* __restrict__ K,
                                                         const float* __restrict__ V,
                                                         const float* __restrict__ valid,
                                                         float* __restrict__ O, int L, int D,
                                                         float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int S = DH + 4;  // = 4 (mod 16): the K (row g, col t) and V (row 2t, col g) reads are conflict-free
  constexpr int C = DH / 4;  // 16-byte chunks per row
  constexpr int KS = DH / 8;
  float* Qs = smem;
  float* Ks = Qs + kQTile * S;
  float* Vs = Ks + 2 * kKTile * S;
  float* madd = Vs + 2 * kKTile * S;
  const int q0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * L * D + (size_t)h * DH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;

  for (int i = threadIdx.x; i < kQTile * C; i += blockDim.x) {
    const int r = i / C, c = (i % C) * 4;
    const bool ok = q0 + r < L;
    cp_async16(Qs + r * S + c, ok ? Q + base + (size_t)(q0 + r) * D + c : Q, ok);
  }
  auto load_kv = [&](int buf, int kt) {
    const int j0 = kt * kKTile;
    float* kd = Ks + buf * kKTile * S;
    float* vd = Vs + buf * kKTile * S;
    for (int i = threadIdx.x; i < kKTile * C; i += blockDim.x) {
      const int r = i / C, c = (i % C) * 4;
      const bool ok = j0 + r < L;
      const size_t off = base + (size_t)(j0 + r) * D + c;
      cp_async16(kd + r * S + c, ok ? K + off : K, ok);
      cp_async16(vd + r * S + c, ok ? V + off : V, ok);
    }
    for (int r = threadIdx.x; r < kKTile; r += blockDim.x) {
      const int j = j0 + r;
      madd[buf * kKTile + r] = j >= L ? -INFINITY : (valid[(size_t)b * L + j] != 0.f ? 0.f : kNegInf);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qh[KS][4], ql[KS][4];
  float o[KS][4];
#pragma unroll
  for (int d = 0; d < KS; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[d][i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // rows g and g+8
  const int nkt = (L + kKTile - 1) / kKTile;
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      load_kv((kt + 1) & 1, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
      const float* qp = Qs + (warp * 16 + g) * S + t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        split_tf32(qp[ks * 8], qh[ks][0], ql[ks][0]);
        split_tf32(qp[8 * S + ks * 8], qh[ks][1], ql[ks][1]);
        split_tf32(qp[ks * 8 + 4], qh[ks][2], ql[ks][2]);
        split_tf32(qp[8 * S + ks * 8 + 4], qh[ks][3], ql[ks][3]);
      }
    }
    const float* kc = Ks + (kt & 1) * kKTile * S;
    const float* vc = Vs + (kt & 1) * kKTile * S;
    const float* ma = madd + (kt & 1) * kKTile;

    float s[kKTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKTile / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bh[kKTile / 8][2], bl[kKTile / 8][2];
#pragma unroll
      for (int nt = 0; nt < kKTile / 8; ++nt) {
        const float* kp = kc + (nt * 8 + g) * S + ks * 8 + t;
        split_tf32(kp[0], bh[nt][0], bl[nt][0]);
        split_tf32(kp[4], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < kKTile / 8; ++nt) mma_tf32_16x8x8(s[nt], ql[ks], bh[nt]);
#pragma unroll
      for (int nt = 0; nt < kKTile / 8; ++nt) mma_tf32_16x8x8(s[nt], qh[ks], bl[nt]);
#pragma unroll
      for (int nt = 0; nt < kKTile / 8; ++nt) mma_tf32_16x8x8(s[nt], qh[ks], bh[nt]);
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kKTile / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float add = ma[nt * 8 + 2 * t + (i & 1)];
        const float v = add == -INFINITY ? -INFINITY : s[nt][i] * scale + add;
        s[nt][i] = v;
        if (i < 2) mx_a = fmaxf(mx_a, v);
        else mx_b = fmaxf(mx_b, v);
      }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);  // finite: a tile holds a real key
    const float c_a = expf(m_a - mn_a), c_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= c_a;
    l_b *= c_b;
#pragma unroll
    for (int d = 0; d < KS; ++d) {
      o[d][0] *= c_a;
      o[d][1] *= c_a;
      o[d][2] *= c_b;
      o[d][3] *= c_b;
    }
#pragma unroll
    for (int nt = 0; nt < kKTile / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - m_a);
      s[nt][1] = expf(s[nt][1] - m_a);
      s[nt][2] = expf(s[nt][2] - m_b);
      s[nt][3] = expf(s[nt][3] - m_b);
      l_a += s[nt][0] + s[nt][1];
      l_b += s[nt][2] + s[nt][3];
      // P as the A operand: its k index t stands for key 2t and t+4 for key
      // 2t+1 (the C layout of s), so V's rows are read in the same order
      uint32_t ph[4], pl[4];
      split_tf32(s[nt][0], ph[0], pl[0]);
      split_tf32(s[nt][2], ph[1], pl[1]);
      split_tf32(s[nt][1], ph[2], pl[2]);
      split_tf32(s[nt][3], ph[3], pl[3]);
      const float* vp = vc + (nt * 8 + 2 * t) * S + g;
      uint32_t bh[KS][2], bl[KS][2];
#pragma unroll
      for (int d = 0; d < KS; ++d) {
        split_tf32(vp[d * 8], bh[d][0], bl[d][0]);
        split_tf32(vp[S + d * 8], bh[d][1], bl[d][1]);
      }
#pragma unroll
      for (int d = 0; d < KS; ++d) mma_tf32_16x8x8(o[d], pl, bh[d]);
#pragma unroll
      for (int d = 0; d < KS; ++d) mma_tf32_16x8x8(o[d], ph, bl[d]);
#pragma unroll
      for (int d = 0; d < KS; ++d) mma_tf32_16x8x8(o[d], ph, bh[d]);
    }
    __syncthreads();  // every warp is done with this K/V buffer before it is refilled
  }
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
#pragma unroll
  for (int d = 0; d < KS; ++d) {
    const int c = d * 8 + 2 * t;
    if (ra < L) {
      O[base + (size_t)ra * D + c] = o[d][0] / l_a;
      O[base + (size_t)ra * D + c + 1] = o[d][1] / l_a;
    }
    if (rb < L) {
      O[base + (size_t)rb * D + c] = o[d][2] / l_b;
      O[base + (size_t)rb * D + c + 1] = o[d][3] / l_b;
    }
  }
}

// ---------------------------------------------------------------------------
// launch 4: x1 = LayerNorm(ctx Wo^T + bo + h)
// ---------------------------------------------------------------------------
template <int MT>
__global__ void __launch_bounds__(32 * k_groups(MT) * 8, 1) smt_out_ln(const float* __restrict__ X,
                                                  const float* __restrict__ Wo,
                                                  const float* __restrict__ bo,
                                                  const float* __restrict__ R,
                                                  const float* __restrict__ gam,
                                                  const float* __restrict__ bet,
                                                  float* __restrict__ Y, int M, int D) {
  extern __shared__ __align__(16) float smem[];
  const int ldt = D + 4;
  float* T = smem;
  float* stage = T + MT * 16 * ldt;
  const int m0 = blockIdx.x * MT * 16;
  const int rows = min(MT * 16, M - m0);
  float acc[MT][4][4];
  gemm_rows<MT, kStagesRows, k_groups(MT), true, true>(acc, X + (size_t)m0 * D, D, rows, nullptr, 0,
                                                       Wo, D, D, stage);
  for_acc(acc, D, [&](int r, int c, float2 v) {
    if (r < rows) {
      const float2 b = ld2(bo + c), res = ld2(R + (size_t)(m0 + r) * D + c);
      st2(T + r * ldt + c, make_float2(v.x + b.x + res.x, v.y + b.y + res.y));
    }
  });
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nw) {
    const float* x = T + r * ldt;
    float mean, inv;
    row_stats(x, D, mean, inv);
    for (int c = lane; c < D; c += 32)
      Y[(size_t)(m0 + r) * D + c] = (x[c] - mean) * inv * gam[c] + bet[c];
  }
}

// ---------------------------------------------------------------------------
// launch 5: mem = LayerNorm(relu(x1 W0^T + b0) W1^T + b1 + x1), then the
// cross-attention's Kc = mem Wk^T + bk and Vc = mem Wv^T + bv from the rows
// in shared memory; row L-1 of each batch row of mem goes to `last`.
// ---------------------------------------------------------------------------
struct FfnArgs {
  const float *w0, *b0, *w1, *b1, *gam, *bet, *wk, *bk, *wv, *bv;
  float *kc, *vc, *last;
};

template <int MT>
__global__ void __launch_bounds__(32 * k_groups(MT) * 8, 1) smt_ffn_kv(const float* __restrict__ X, FfnArgs p, int M,
                                                  int L, int D) {
  extern __shared__ __align__(16) float smem[];
  const int ldt = D + 4;
  float* T = smem;
  float* stage = T + MT * 16 * ldt;
  const int m0 = blockIdx.x * MT * 16;
  const int rows = min(MT * 16, M - m0);
  float acc[MT][4][4];
  gemm_rows<MT, kStagesRows, k_groups(MT), true, true>(acc, X + (size_t)m0 * D, D, rows, nullptr, 0,
                                                       p.w0, D, D, stage);
  for_acc(acc, D, [&](int r, int c, float2 v) {
    const float2 b = ld2(p.b0 + c);
    st2(T + r * ldt + c, make_float2(fmaxf(v.x + b.x, 0.f), fmaxf(v.y + b.y, 0.f)));
  });
  __syncthreads();
  gemm_rows<MT, kStagesRows, k_groups(MT), false, true>(acc, nullptr, 0, 0, T, ldt, p.w1, D, D, stage);
  // gemm_rows ends on a barrier, so T is free to take the pre-norm rows
  for_acc(acc, D, [&](int r, int c, float2 v) {
    float2 y = make_float2(0.f, 0.f);
    if (r < rows) {
      const float2 b = ld2(p.b1 + c), res = ld2(X + (size_t)(m0 + r) * D + c);
      y = make_float2(v.x + b.x + res.x, v.y + b.y + res.y);
    }
    st2(T + r * ldt + c, y);
  });
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nw) {
    float* x = T + r * ldt;
    float mean, inv;
    row_stats(x, D, mean, inv);
    const int m = m0 + r;
    float* last = m % L == L - 1 ? p.last + (size_t)(m / L) * D : nullptr;
    for (int c = lane; c < D; c += 32) {
      const float y = (x[c] - mean) * inv * p.gam[c] + p.bet[c];
      x[c] = y;
      if (last != nullptr) last[c] = y;
    }
  }
  __syncthreads();
  gemm_rows<MT, kStagesRows, k_groups(MT), false, true>(acc, nullptr, 0, 0, T, ldt, p.wk, D, D, stage);
  for_acc(acc, D, [&](int r, int c, float2 v) {
    const float2 b = ld2(p.bk + c);
    if (r < rows) st2(p.kc + (size_t)(m0 + r) * D + c, make_float2(v.x + b.x, v.y + b.y));
  });
  gemm_rows<MT, kStagesRows, k_groups(MT), false, true>(acc, nullptr, 0, 0, T, ldt, p.wv, D, D, stage);
  for_acc(acc, D, [&](int r, int c, float2 v) {
    const float2 b = ld2(p.bv + c);
    if (r < rows) st2(p.vc + (size_t)(m0 + r) * D + c, make_float2(v.x + b.x, v.y + b.y));
  });
}

// ---------------------------------------------------------------------------
// launch 6: the decoder, one cluster of kTailCluster CTAs per batch row. Every
// product has one row, so it is an f32 matrix-vector product on the CUDA
// cores; CTA c computes outputs [c*D/8, (c+1)*D/8) of each (a warp per 4
// outputs, lanes over K in float4, coalesced weight rows) and stores them
// into every CTA's copy of the vector (distributed shared memory), then the
// cluster barrier; so each CTA streams an eighth of the 1.5 MB of weights
// (at D=256) and the LayerNorms run on the whole vector in every CTA. CTA c
// takes the cross-attention heads c, c+8, ...
// ---------------------------------------------------------------------------
struct Weights {
  const float* p[42];
};

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < nw; ++w) r += red[w];
  __syncthreads();
  return r;
}

// y[n0 .. n0+per) = W x + b (optionally ReLU) into every CTA of the cluster;
// x in shared memory. The caller's cluster_sync publishes y.
__device__ void matvec_slice(const float* __restrict__ W, const float* __restrict__ bias,
                             const float* x, float* y, int n0, int per, int D, bool relu) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int D4 = D / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (int j = warp * 4; j < per; j += nw * 4) {
    const int n = n0 + j;
    const float4* w4 = reinterpret_cast<const float4*>(W + (size_t)n * D);
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int k = lane; k < D4; k += 32) {
      const float4 xv = x4[k];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 wv = w4[u * D4 + k];
        s[u] = fmaf(wv.x, xv.x, fmaf(wv.y, xv.y, fmaf(wv.z, xv.z, fmaf(wv.w, xv.w, s[u]))));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) s[u] = warp_sum(s[u]);
    if (lane < 4 * kTailCluster) {
      const int u = lane / kTailCluster;
      float v = (u == 0 ? s[0] : u == 1 ? s[1] : u == 2 ? s[2] : s[3]) + bias[n + u];
      if (relu) v = fmaxf(v, 0.f);
      st_cluster(y + n + u, lane % kTailCluster, v);
    }
  }
}

// y = LayerNorm(x + r) over D values in shared memory; ends on a barrier
__device__ void ln_vec(const float* x, const float* r, const float* __restrict__ gam,
                       const float* __restrict__ bet, float* y, int D, float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = x[i] + r[i];
    y[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / (float)D;
  float q = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = y[i] - mean;
    q = fmaf(d, d, q);
  }
  const float inv = 1.0f / sqrtf(block_sum(q, red) / (float)D + kLnEps);
  for (int i = threadIdx.x; i < D; i += blockDim.x) y[i] = (y[i] - mean) * inv * gam[i] + bet[i];
  __syncthreads();
}

template <int DH>
__global__ void __launch_bounds__(kTailThreads) smt_tail(const float* __restrict__ tgt,
                                                         const float* __restrict__ Kc,
                                                         const float* __restrict__ Vc,
                                                         const float* __restrict__ valid,
                                                         Weights w, float* __restrict__ out,
                                                         int L, int D) {
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x % kTailCluster, b = blockIdx.x / kTailCluster;
  const int H = D / DH, per = D / kTailCluster, n0 = c * per;
  const int heads = c < H ? (H - 1 - c) / kTailCluster + 1 : 0;  // c, c+8, ...
  float* x = smem;  // ten vectors of D: tgt, sv, a, t1, q, ctx, co, t2, f0, f1
  float* sv = x + D;
  float* a = sv + D;
  float* t1 = a + D;
  float* q = t1 + D;
  float* ctx = q + D;
  float* co = ctx + D;
  float* t2 = co + D;
  float* f0 = t2 + D;
  float* f1 = f0 + D;
  float* part = f1 + D;            // kTailThreads
  float* red = part + kTailThreads;  // 32
  float* hsum = red + 32;          // 32
  float* logit = hsum + 32;        // heads x L
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i = threadIdx.x; i < D; i += blockDim.x) x[i] = tgt[(size_t)b * D + i];
  cluster_sync();  // every CTA runs (its shared memory takes remote stores) and x is visible
  // self-attention over its one key: out(v(tgt)); then LayerNorm_0
  matvec_slice(w.p[20], w.p[21], x, sv, n0, per, D, false);
  cluster_sync();
  matvec_slice(w.p[22], w.p[23], sv, a, n0, per, D, false);
  cluster_sync();
  ln_vec(x, a, w.p[32], w.p[33], t1, D, red);
  matvec_slice(w.p[24], w.p[25], t1, q, n0, per, D, false);
  cluster_sync();
  // cross-attention of the one query over the row's L encoder outputs
  const float scale = 1.0f / sqrtf((float)DH);
  const float* vrow = valid + (size_t)b * L;
  for (int i = threadIdx.x; i < heads * L; i += blockDim.x) {
    const int hi = i / L, j = i - hi * L, h = c + hi * kTailCluster;
    const float4* kp = reinterpret_cast<const float4*>(Kc + ((size_t)b * L + j) * D + h * DH);
    const float4* qp = reinterpret_cast<const float4*>(q + h * DH);
    float dot = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 k4 = kp[d4], q4 = qp[d4];
      dot = fmaf(q4.x, k4.x, fmaf(q4.y, k4.y, fmaf(q4.z, k4.z, fmaf(q4.w, k4.w, dot))));
    }
    logit[i] = dot * scale + (vrow[j] != 0.f ? 0.f : kNegInf);
  }
  __syncthreads();
  for (int hi = warp; hi < heads; hi += nw) {
    float* lg = logit + hi * L;
    float mx = -INFINITY;
    for (int j = lane; j < L; j += 32) mx = fmaxf(mx, lg[j]);
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float p = expf(lg[j] - mx);
      lg[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) hsum[hi] = sum;
  }
  __syncthreads();
  constexpr int kSlices = kTailThreads / DH;  // thread (d, slice) sums keys slice, slice + kSlices, ...
  const int d = threadIdx.x % DH, slice = threadIdx.x / DH;
  for (int hi = 0; hi < heads; ++hi) {
    const int h = c + hi * kTailCluster;
    const float* lg = logit + hi * L;
    const float* vp = Vc + (size_t)b * L * D + h * DH + d;
    float acc = 0.f;
#pragma unroll 4
    for (int j = slice; j < L; j += kSlices) acc = fmaf(lg[j], vp[(size_t)j * D], acc);
    part[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < DH) {
      float tot = 0.f;
      for (int s2 = 0; s2 < kSlices; ++s2) tot += part[s2 * DH + threadIdx.x];
      for (int r = 0; r < kTailCluster; ++r) st_cluster(ctx + h * DH + threadIdx.x, r, tot / hsum[hi]);
    }
    __syncthreads();
  }
  cluster_sync();
  matvec_slice(w.p[30], w.p[31], ctx, co, n0, per, D, false);
  cluster_sync();
  ln_vec(t1, co, w.p[34], w.p[35], t2, D, red);
  // FFN, residual + LayerNorm_2
  matvec_slice(w.p[36], w.p[37], t2, f0, n0, per, D, true);
  cluster_sync();
  matvec_slice(w.p[38], w.p[39], f0, f1, n0, per, D, false);
  cluster_sync();  // the last remote store: no CTA touches another's memory after this
  ln_vec(t2, f1, w.p[40], w.p[41], x, D, red);
  for (int i = n0 + threadIdx.x; i < n0 + per; i += blockDim.x) out[(size_t)b * D + i] = x[i];
}

// ---------------------------------------------------------------------------
// the launch plan (mirrored by ops/smt_cuda.py:smt_plan)
// ---------------------------------------------------------------------------
struct Launch {
  int gx, gy, gz, threads;
  long long smem;
  int cluster;  // CTAs of a thread-block cluster along x (1: none)
};

struct Plan {
  int bm;  // rows of a row block
  Launch l[kNumLaunches];
};

// The row blocks of launches 1, 2, 4, 5 hold BM rows. A larger BM reuses
// each staged weight slice over more rows (fewer loads and TF32 splits per
// product), a smaller one makes more blocks: take the largest BM whose
// blocks still reach half of the SMs.
int rows_tile(long long M) {
  if ((M + 63) / 64 >= kSMs / 2) return 64;
  if ((M + 31) / 32 >= kSMs / 2) return 32;
  return 16;
}

// Shared bytes of a row block: the staged slices of [W: D x kPadK][A: BM x
// kPadK] and, for a block that keeps its BM x D rows (resident), those rows.
long long rows_smem(int bm, int D, bool resident) {
  if (!resident) return 4LL * kStagesProj * (D + bm) * kPadK;
  return 4LL * ((long long)bm * (D + 4) + (long long)kStagesRows * (D + bm) * kPadK);
}

int plan_make(int B, int L, int F, int D, int H, Plan* p) {
  if (B < 1 || L < 1 || F < 1 || H < 1 || D % H != 0 || D % 32 != 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  const int dh = D / H;
  if (dh != 8 && dh != 16 && dh != 32 && dh != 64) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * L;
  const int bm = rows_tile(M);
  const int gm = (int)((M + bm - 1) / bm);
  p->bm = bm;
  const long long tail_heads = (H + kTailCluster - 1) / kTailCluster;
  const int rt = D * k_groups(bm / 16);  // threads of a row block that keeps its rows
  p->l[0] = {gm, 1, 1, rt, rows_smem(bm, D, true), 1};   // fusion
  p->l[1] = {gm, 3, 1, D, rows_smem(bm, D, false), 1};   // qkv
  p->l[2] = {(L + kQTile - 1) / kQTile, H, B, kAttnThreads,
             4LL * ((kQTile + 4 * kKTile) * (dh + 4) + 2 * kKTile), 1};  // attention
  p->l[3] = {gm, 1, 1, rt, rows_smem(bm, D, true), 1};   // out + LN
  p->l[4] = {gm, 1, 1, rt, rows_smem(bm, D, true), 1};   // FFN + LN + K/V
  p->l[5] = {kTailCluster * B, 1, 1, kTailThreads,
             4LL * (10LL * D + kTailThreads + 64 + tail_heads * L), kTailCluster};  // decoder
  for (int i = 0; i < kNumLaunches; ++i)
    if (p->l[i].smem > kMaxSmem || p->l[i].gy > 65535 || p->l[i].gz > 65535)
      return (int)cudaErrorInvalidValue;
  return 0;
}

dim3 grid_of(const Launch& l) { return dim3(l.gx, l.gy, l.gz); }

// One launch of `kernel` as the plan's launch l says: grid, threads,
// dynamic shared memory (allowed above 48 KB first) and cluster.
template <typename... Params, typename... Args>
int launch(const Launch& l, cudaStream_t st, void (*kernel)(Params...), Args... args) {
  if (l.smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid_of(l);
  cfg.blockDim = dim3(l.threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)l.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = l.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = l.cluster > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Buffers of one call, in the workspace: h, q (then x1), k (then the
// cross-attention K), v (then its V), the attention context (M x D each),
// and encoder row L-1 of each batch row (B x D).
struct Buffers {
  float *h, *qb, *kb, *vb, *cb, *last;
};

template <int MT, bool kVec>
int launch_fusion_qkv(const Plan& p, cudaStream_t st, const float* entries, const float* const* w,
                      const Buffers& bf, int M, int F, int D) {
  int rc = launch(p.l[0], st, smt_fusion<MT, kVec>, entries, w[0], w[1], w[2], w[3], bf.h, M, F, D);
  if (rc != 0) return rc;
  ProjArgs pa{{w[4], w[6], w[8]}, {w[5], w[7], w[9]}, {bf.qb, bf.kb, bf.vb}};
  return launch(p.l[1], st, smt_proj<MT>, (const float*)bf.h, pa, M, D);
}

template <int MT>
int launch_out_ffn(const Plan& p, cudaStream_t st, const float* const* w, const Buffers& bf, int M,
                   int L, int D) {
  int rc = launch(p.l[3], st, smt_out_ln<MT>, (const float*)bf.cb, w[10], w[11],
                  (const float*)bf.h, w[12], w[13], bf.qb, M, D);
  if (rc != 0) return rc;
  FfnArgs fa{w[14], w[15], w[16], w[17], w[18], w[19], w[26], w[27], w[28], w[29],
             bf.kb, bf.vb, bf.last};
  return launch(p.l[4], st, smt_ffn_kv<MT>, (const float*)bf.qb, fa, M, L, D);
}

template <int DH>
int launch_attention(const Plan& p, cudaStream_t st, const float* valid, const Buffers& bf, int L,
                     int D) {
  return launch(p.l[2], st, smt_attn<DH>, (const float*)bf.qb, (const float*)bf.kb,
                (const float*)bf.vb, valid, bf.cb, L, D, 1.0f / sqrtf((float)DH));
}

template <int DH>
int launch_tail(const Plan& p, cudaStream_t st, const float* valid, const float* const* w,
                const float* goal, const Buffers& bf, float* out, int L, int D) {
  Weights wt;
  for (int i = 0; i < 42; ++i) wt.p[i] = w[i];
  return launch(p.l[5], st, smt_tail<DH>, goal != nullptr ? goal : (const float*)bf.last,
                (const float*)bf.kb, (const float*)bf.vb, valid, wt, out, L, D);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// Number of weight pointers smt_encode expects, in this order (PyTorch
// layouts, Linear weights (out, in)):
//  0 fusion0.w  1 fusion0.b  2 fusion1.w  3 fusion1.b
//  enc0: 4 q.w 5 q.b 6 k.w 7 k.b 8 v.w 9 v.b 10 out.w 11 out.b
//        12 ln0.w 13 ln0.b 14 ff0.w 15 ff0.b 16 ff1.w 17 ff1.b 18 ln1.w 19 ln1.b
//  dec0: 20 self.v.w 21 self.v.b 22 self.out.w 23 self.out.b
//        24 cross.q.w 25 cross.q.b 26 cross.k.w 27 cross.k.b 28 cross.v.w 29 cross.v.b
//        30 cross.out.w 31 cross.out.b 32 ln0.w 33 ln0.b 34 ln1.w 35 ln1.b
//        36 ff0.w 37 ff0.b 38 ff1.w 39 ff1.b 40 ln2.w 41 ln2.b
extern "C" int smt_encode_num_weights() { return 42; }

extern "C" int smt_encode_num_launches() { return kNumLaunches; }

// Workspace floats of one call: the Buffers (five of B*L x D and one of
// B x D).
extern "C" long long smt_encode_workspace_floats(int B, int L, int D) {
  return 5LL * B * L * D + (long long)B * D;
}

// Launch i of the plan for this shape: out = {grid x, y, z, threads, dynamic
// shared bytes, cluster CTAs, rows of a row block}. Returns 0, or an error
// code for a shape the kernel does not take.
extern "C" int smt_encode_launch_info(int B, int L, int F, int D, int H, int i, long long* out) {
  Plan p;
  const int rc = plan_make(B, L, F, D, H, &p);
  if (rc != 0) return rc;
  if (i < 0 || i >= kNumLaunches) return (int)cudaErrorInvalidValue;
  const Launch& l = p.l[i];
  out[0] = l.gx;
  out[1] = l.gy;
  out[2] = l.gz;
  out[3] = l.threads;
  out[4] = l.smem;
  out[5] = l.cluster;
  out[6] = p.bm;
  return 0;
}

// entries (B, L, F), valid (B, L), goal (B, D) or null, out (B, D); all f32
// and contiguous; the workspace (smt_encode_workspace_floats(B, L, D)
// floats) and every weight but fusion0.w 16-byte aligned (an unaligned
// entries or fusion0.w, or F % 4 != 0, takes 4-byte copies). Launches on
// `stream`; returns cudaGetLastError() after the launches.
extern "C" int smt_encode(const float* entries, const float* valid, const float* goal,
                          const float* const* w, float* out, float* ws, int B, int L, int F,
                          int D, int H, void* stream) {
  Plan p;
  int rc = plan_make(B, L, F, D, H, &p);
  if (rc != 0) return rc;
  // the operands read in 8- or 16-byte pieces (cp.async, float2, float4):
  // the workspace and every weight but fusion0's (which falls back to 4-byte
  // copies with the entries)
  if (!aligned16(ws)) return (int)cudaErrorMisalignedAddress;
  for (int i = 1; i < 42; ++i)
    if (!aligned16(w[i])) return (int)cudaErrorMisalignedAddress;
  const int dh = D / H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * L;
  const size_t big = (size_t)M * D;
  const Buffers bf{ws, ws + big, ws + 2 * big, ws + 3 * big, ws + 4 * big, ws + 5 * big};
  const bool vec = F % 4 == 0 && aligned16(entries) && aligned16(w[0]);

  // 1-2: fusion MLP, QKV
  switch (p.bm * 2 + (vec ? 1 : 0)) {
    case 129: rc = launch_fusion_qkv<4, true>(p, st, entries, w, bf, M, F, D); break;
    case 128: rc = launch_fusion_qkv<4, false>(p, st, entries, w, bf, M, F, D); break;
    case 65: rc = launch_fusion_qkv<2, true>(p, st, entries, w, bf, M, F, D); break;
    case 64: rc = launch_fusion_qkv<2, false>(p, st, entries, w, bf, M, F, D); break;
    case 33: rc = launch_fusion_qkv<1, true>(p, st, entries, w, bf, M, F, D); break;
    default: rc = launch_fusion_qkv<1, false>(p, st, entries, w, bf, M, F, D); break;
  }
  if (rc != 0) return rc;
  // 3: self-attention
  switch (dh) {
    case 8: rc = launch_attention<8>(p, st, valid, bf, L, D); break;
    case 16: rc = launch_attention<16>(p, st, valid, bf, L, D); break;
    case 32: rc = launch_attention<32>(p, st, valid, bf, L, D); break;
    default: rc = launch_attention<64>(p, st, valid, bf, L, D); break;
  }
  if (rc != 0) return rc;
  // 4-5: out-projection + LN, FFN + LN + cross K/V
  switch (p.bm) {
    case 64: rc = launch_out_ffn<4>(p, st, w, bf, M, L, D); break;
    case 32: rc = launch_out_ffn<2>(p, st, w, bf, M, L, D); break;
    default: rc = launch_out_ffn<1>(p, st, w, bf, M, L, D); break;
  }
  if (rc != 0) return rc;
  // 6: decoder
  switch (dh) {
    case 8: rc = launch_tail<8>(p, st, valid, w, goal, bf, out, L, D); break;
    case 16: rc = launch_tail<16>(p, st, valid, w, goal, bf, out, L, D); break;
    case 32: rc = launch_tail<32>(p, st, valid, w, goal, bf, out, L, D); break;
    default: rc = launch_tail<64>(p, st, valid, w, goal, bf, out, L, D); break;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
