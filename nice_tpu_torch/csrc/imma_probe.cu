// A probe of the tensor cores' integer rate, built and timed only by
// chip_smoke.py, which bounds K5 with it: how many 16x16x16 u8 x u8 -> s32
// wmma products (mma_sync, the form K5 issues) one SM completes per clock.
// NVIDIA's int8 figure for the H100 SXM (1,979 dense TOP/s at 1,830 MHz,
// 4,096 multiply-adds per SM per clock, one such product a clock) is
// wgmma's; mma_sync may reach less of it, so the smoke measures it.
//
// Each warp runs four independent accumulator chains over fragments held
// in registers, so neither memory nor one chain's latency limits it. The
// loop is not unrolled: its body's IMMA instructions, over its four
// products, are what one product compiles to.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kChains = 4;

__global__ void __launch_bounds__(256) imma_probe_kernel(int iters, int* out) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, unsigned char, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, unsigned char, wmma::col_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> c[kChains];
  wmma::fill_fragment(a, (unsigned char)(threadIdx.x & 3));
  wmma::fill_fragment(b, (unsigned char)1);
#pragma unroll
  for (int k = 0; k < kChains; ++k) wmma::fill_fragment(c[k], 0);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {  // one body: kChains products
#pragma unroll
    for (int k = 0; k < kChains; ++k) wmma::mma_sync(c[k], a, b, c[k]);
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    for (int e = 0; e < c[k].num_elements; ++e) s += c[k].x[e];
  }
  atomicAdd(out, s);  // keeps every product live
}

}  // namespace

extern "C" {

// blocks x 8 warps x iters x 4 products (256 threads a block); returns
// cudaGetLastError().
int nice_imma_probe(int blocks, int iters, void* out, void* stream) {
  imma_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(iters,
                                                              (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
