// CPU emulation of the CUDA subset that zig_tfhe_tpu_torch/csrc/*.cu use,
// for tests/test_torch_kernel_emulation.py.  A kernel source is compiled
// with the host C++ compiler after three textual rewrites (done by the
// test): the `mma.sync` asm becomes emu_mma, `kernel<<<...>>>(args)`
// becomes emu_launch, and the dynamic shared array points at g_smem.
//
// One std::thread per CUDA thread, one block at a time; __syncthreads is a
// std::barrier over the block, and mma.sync.m16n8k32 s8 gathers the 32
// lanes' fragments of a warp and computes each lane's accumulators from
// them.  The float intrinsics round to nearest even like the card's (build
// with -ffp-contract=off so no multiply-add is fused); __byte_perm is the
// default mode.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(8) int2 { int x, y; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline int2 make_int2(int a, int b) { return {a, b}; }

inline thread_local dim3 threadIdx, blockIdx;
inline std::barrier<>* g_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_barrier;
alignas(16) inline unsigned char g_smem[1 << 20];

inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }
inline int __float2int_rn(float f) { return static_cast<int>(std::nearbyint(f)); }
inline float __int2float_rn(int x) { return static_cast<float>(x); }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
// byte i of the result = byte (s >> 4i) & 7 of the 8-byte value {y, x}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<uint32_t>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

struct WarpFragments { uint32_t a[32][4]; uint32_t b[32][2]; };
inline WarpFragments g_frag[32];

inline int emu_s8(uint32_t w, int byte) {
  return static_cast<int8_t>((w >> (8 * byte)) & 0xFF);
}

// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: lane (g = lane/4,
// t = lane%4) holds A rows g, g+8 at k = 4t.., 16+4t..; B column g at the
// same k; C rows g, g+8, columns 2t, 2t+1.
inline void emu_mma(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpFragments& f = g_frag[warp];
  for (int i = 0; i < 4; ++i) f.a[lane][i] = a[i];
  f.b[lane][0] = b0;
  f.b[lane][1] = b1;
  g_warp_barrier[warp]->arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    uint32_t acc = 0;
    for (int k = 0; k < 32; ++k) {
      const int a_lane = (row % 8) * 4 + (k % 16) / 4;
      const int a_reg = (row >= 8 ? 1 : 0) + (k >= 16 ? 2 : 0);
      const int b_lane = col * 4 + (k % 16) / 4;
      acc += static_cast<uint32_t>(emu_s8(f.a[a_lane][a_reg], k % 4) *
                                   emu_s8(f.b[b_lane][k >= 16], k % 4));
    }
    c[i] = static_cast<int>(static_cast<uint32_t>(c[i]) + acc);
  }
  g_warp_barrier[warp]->arrive_and_wait();
}

template <class F>
inline void emu_launch(F f, dim3 grid, int threads, size_t = 0, void* = nullptr) {
  std::barrier<> block(threads);
  g_block_barrier = &block;
  g_warp_barrier.clear();
  for (int w = 0; w < (threads + 31) / 32; ++w)
    g_warp_barrier.emplace_back(std::make_unique<std::barrier<>>(32));
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::vector<std::thread> pool;
        for (int i = 0; i < threads; ++i)
          pool.emplace_back([&, i] {
            threadIdx = dim3(i);
            blockIdx = dim3(x, y, z);
            f();
          });
        for (auto& th : pool) th.join();
      }
}
