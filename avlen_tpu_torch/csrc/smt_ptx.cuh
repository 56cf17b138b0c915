// Device helpers of smt_encode.cu: f32 products on Hopper's tensor cores
// through TF32 (the rounding and mma.sync m16n8k8), asynchronous
// global->shared copies (cp.async), and the thread-block cluster's barrier
// and shared-memory stores. Every inline-PTX instruction of smt_encode.cu is
// in this file.
#pragma once

#include <stdint.h>

// x rounded to TF32 (10-bit mantissa, to nearest, ties away from zero); the
// low 13 bits of the result are zero. For finite x below the largest TF32
// this is cvt.rna.tf32.f32 bit for bit, done with two integer operations,
// which ran faster than the cvt instruction on an H100.
__device__ __forceinline__ uint32_t cvt_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a (16x8, row) * b (8x8, col), TF32 inputs, f32 accumulate. Fragments
// of lane l (g = l/4, t = l%4): a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}. Not volatile: the compiler may interleave
// independent products.
__device__ __forceinline__ void mma_tf32_16x8x8(float (&d)[4], const uint32_t (&a)[4],
                                                const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !full.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !full.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Barrier of every thread of the cluster: arrive releases this thread's
// shared-memory stores (local and remote), wait acquires the others'.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// *p = v in the shared memory of CTA `rank` of this cluster, p being the
// address of the same variable in this CTA's shared memory.
__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float v) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v) : "memory");
}

