// CPU emulation of the CUDA subset that zig_tfhe_tpu_torch/csrc/*.cu use,
// for tests/test_torch_kernel_emulation.py.  A kernel source is compiled
// with the host C++ compiler after textual rewrites (done by the test):
// the includes of <cuda_runtime.h> and of csrc/hopper_prims.cuh become
// this header, `kernel<<<...>>>(args)` becomes emu_launch, and the dynamic
// shared array points at g_smem.
//
// One std::thread per CUDA thread, one block at a time; __syncthreads is a
// std::barrier over the block.  The float intrinsics round to nearest even
// like the card's (build with -ffp-contract=off so no multiply-add is
// fused); __byte_perm is the default mode.
//
// namespace hopper holds host versions of exactly the functions of
// csrc/hopper_prims.cuh: an mbarrier is a mutex-guarded (arrivals, bytes,
// phase) record beside shared memory, a TMA load copies its box at once
// (zeros outside the tensor) into the 128- or 64-byte swizzled layout and
// completes its bytes on the barrier, and a wgmma reads both operands
// through their descriptors (start, 8-row stride, swizzle) and computes
// the calling thread's own sums in the m64nNk32 fragment layout, at issue;
// the commit is a barrier over the warpgroup, as the instruction is
// collective.  A wgmma with A from registers gathers the warpgroup's 128
// threads' A fragments first (a barrier over the warpgroup), then computes
// each thread's own sums from them.  Computing at issue cannot show a
// register rewritten while a wgmma on the card still reads it.
#pragma once

#include <algorithm>
#include <barrier>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <atomic>
#include <cstring>
#include <memory>
#include <mutex>
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
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(8) int2 { int x, y; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline int2 make_int2(int a, int b) { return {a, b}; }


inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline std::barrier<>* g_block_barrier = nullptr;
alignas(1024) inline unsigned char g_smem[1 << 18];
inline std::vector<std::unique_ptr<std::barrier<>>> g_warpgroup_barrier;

inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }
inline int __float2int_rn(float f) { return static_cast<int>(std::nearbyint(f)); }
inline float __int2float_rn(int x) { return static_cast<float>(x); }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
// the bits of a float as an int and back
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST);
}
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
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

template <class F>
inline void emu_launch(F f, dim3 grid, int threads, size_t = 0, void* = nullptr) {
  std::barrier<> block(threads);
  g_block_barrier = &block;
  gridDim = grid;
  blockDim = dim3(threads);
  g_warpgroup_barrier.clear();
  for (int w = 0; w < threads / 128; ++w)
    g_warpgroup_barrier.emplace_back(std::make_unique<std::barrier<>>(128));
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

// -- host versions of csrc/hopper_prims.cuh ----------------------------------
struct CUtensorMap {
  const unsigned char* base;
  int rank;
  uint64_t dims[3], strides[2];
  uint32_t box[3];
};

inline int g_emu_sm_count = 4;
// the SM count the entry points size their tiles by
extern "C" __attribute__((used)) inline void emu_set_sm_count(int n) {
  g_emu_sm_count = n;
}

namespace hopper {

struct EmuMbar {
  std::mutex m;
  int expected = 0, pending = 0;
  long tx = 0;
  std::atomic<uint32_t> phase{0};
};
inline EmuMbar g_mbar[sizeof(g_smem) / 8];

inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(static_cast<const unsigned char*>(p) - g_smem);
}
inline unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}
inline EmuMbar& emu_bar(const uint64_t* bar) { return g_mbar[smem_u32(bar) / 8]; }

// a phase ends when every arrival and every announced byte has come
inline void emu_mbar_settle(EmuMbar& b) {
  if (b.pending == 0 && b.tx == 0) {
    b.pending = b.expected;
    b.phase.store(b.phase.load() ^ 1u);
  }
}
inline void mbar_init(uint64_t* bar, int count) {
  EmuMbar& b = emu_bar(bar);
  std::lock_guard<std::mutex> l(b.m);
  b.expected = b.pending = count;
  b.tx = 0;
  b.phase.store(0);
}
inline void fence_barrier_init() {}
inline void mbar_arrive(uint64_t* bar) {
  EmuMbar& b = emu_bar(bar);
  std::lock_guard<std::mutex> l(b.m);
  --b.pending;
  emu_mbar_settle(b);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  EmuMbar& b = emu_bar(bar);
  std::lock_guard<std::mutex> l(b.m);
  b.tx += bytes;
  --b.pending;
  emu_mbar_settle(b);
}
inline void emu_complete_tx(uint64_t* bar, uint32_t bytes) {
  EmuMbar& b = emu_bar(bar);
  std::lock_guard<std::mutex> l(b.m);
  b.tx -= bytes;
  emu_mbar_settle(b);
}
// a wait that does not end within a minute is a deadlock: say where, stop
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  EmuMbar& b = emu_bar(bar);
  const auto t0 = std::chrono::steady_clock::now();
  for (long n = 1; b.phase.load() == parity; ++n) {
    std::this_thread::yield();
    if (n % 4096 == 0 &&
        std::chrono::steady_clock::now() - t0 > std::chrono::seconds(60)) {
      std::fprintf(stderr, "cuda_emu: thread %u of block %u waits forever on the "
                   "mbarrier at %u (parity %u, %d arrivals and %ld bytes pending)\n",
                   threadIdx.x, blockIdx.x, smem_u32(bar), parity, b.pending, b.tx);
      std::this_thread::sleep_for(std::chrono::seconds(2));   // let the others say too
      std::abort();
    }
  }
}

// byte `off` of a tile whose rows are `sw` bytes lands at the swizzled offset
inline uint32_t emu_swizzle(uint32_t off, uint32_t sw) {
  return off ^ (((off >> 7) & (sw == 128 ? 7u : 3u)) << 4);
}

inline void emu_tma_load(void* dst, const CUtensorMap* m, int c0, int c1, int c2,
                         uint64_t* bar) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  if (smem_u32(d) % 1024) std::abort();   // the swizzle is on address bits
  const uint32_t sw = m->box[0];
  const uint32_t nz = m->rank == 3 ? m->box[2] : 1;
  uint32_t row = 0;
  for (uint32_t z = 0; z < nz; ++z)
    for (uint32_t y = 0; y < m->box[1]; ++y, ++row)
      for (uint32_t x = 0; x < sw; ++x) {
        const int64_t gx = c0 + static_cast<int64_t>(x), gy = c1 + static_cast<int64_t>(y),
                      gz = c2 + static_cast<int64_t>(z);
        const bool in = gx >= 0 && gy >= 0 && gz >= 0 &&
                        gx < static_cast<int64_t>(m->dims[0]) &&
                        gy < static_cast<int64_t>(m->dims[1]) &&
                        (m->rank < 3 || gz < static_cast<int64_t>(m->dims[2]));
        d[emu_swizzle(row * sw + x, sw)] =
            in ? m->base[gx + gy * m->strides[0] +
                         (m->rank == 3 ? gz * m->strides[1] : 0)]
               : 0;
      }
  std::atomic_thread_fence(std::memory_order_seq_cst);
  emu_complete_tx(bar, row * sw);
}
inline void tma_load_2d(void* dst, const CUtensorMap* m, int c0, int c1,
                        uint64_t* bar) {
  emu_tma_load(dst, m, c0, c1, 0, bar);
}
inline void tma_load_3d(void* dst, const CUtensorMap* m, int c0, int c1, int c2,
                        uint64_t* bar) {
  emu_tma_load(dst, m, c0, c1, c2, bar);
}

// bar.sync id, threads: the id's barrier opens when `threads` threads wait
struct EmuNamedBarrier {
  std::mutex m;
  std::condition_variable cv;
  int waiting = 0;
  unsigned generation = 0;
};
inline EmuNamedBarrier g_named_barrier[16];
inline void named_barrier_sync(int id, int threads) {
  if (id < 1 || id > 15) std::abort();
  EmuNamedBarrier& b = g_named_barrier[id];
  std::unique_lock<std::mutex> l(b.m);
  const unsigned g = b.generation;
  if (++b.waiting == threads) {
    b.waiting = 0;
    ++b.generation;
    b.cv.notify_all();
  } else {
    b.cv.wait(l, [&] { return b.generation != g; });
  }
}
template <int N> inline void reg_dec() {}
template <int N> inline void reg_inc() {}

template <int SW>
inline uint64_t make_desc(const void* p) {
  static_assert(SW == 128 || SW == 64, "swizzle span");
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFFu) >> 4) |
         (1ull << 16) | (static_cast<uint64_t>((8 * SW) >> 4) << 32) |
         (static_cast<uint64_t>(SW == 128 ? 1 : 2) << 62);
}
inline void wgmma_fence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
// A wgmma is collective: a group retires only once all four warps of the
// warpgroup have issued it.  Here each thread computes its own sums at
// issue, so the commit is where the warpgroup meets; a thread that then
// sees a group retired (wgmma_wait) knows every thread has read the stage.
inline void wgmma_commit() {
  g_warpgroup_barrier[threadIdx.x >> 7]->arrive_and_wait();
}
template <int N> inline void wgmma_wait() {}
template <int REGS> inline void fence_acc(int (&)[REGS]) {}
template <int REGS> inline void fence_acc(uint32_t (&)[REGS]) {}

// element (row, k) of the K-major operand a descriptor points at
inline int emu_operand(uint64_t desc, int row, int k) {
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFF) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFF) << 4;
  const uint32_t sw = (desc >> 62) == 1 ? 128 : 64;
  const uint32_t addr = start + (row >> 3) * sbo + (row & 7) * sw + k;
  return static_cast<int8_t>(g_smem[emu_swizzle(addr, sw)]);
}

// wgmma.mma_async.m64nNk32.s32.s8.s8, N = 2 * REGS: the calling thread's
// own sums (warp w, g = lane / 4, t = lane % 4: register i is row 16 w + g
// + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 t + i % 2)
template <int REGS>
inline void wgmma_s8(int (&d)[REGS], uint64_t a, uint64_t b, int accumulate) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < REGS; ++i) {
    const int row = 16 * warp + g + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * t + i % 2;
    uint32_t sum = 0;
    for (int k = 0; k < 32; ++k)
      sum += static_cast<uint32_t>(emu_operand(a, row, k) * emu_operand(b, col, k));
    d[i] = static_cast<int>((accumulate ? static_cast<uint32_t>(d[i]) : 0u) + sum);
  }
}

inline int emu_s8(uint32_t w, int byte) {
  return static_cast<int8_t>((w >> (8 * byte)) & 0xFF);
}

// the A fragments of each warpgroup's 128 threads, gathered at issue
struct WarpgroupFragments { uint32_t a[128][4]; };
inline WarpgroupFragments g_wg_frag[4];

// wgmma.mma_async.m64n64k32.s32.s8.s8 with A from registers: thread (warp
// w, g, t) holds a[0] = A[16 w + g][4 t ..], a[1] = A[16 w + g + 8][4 t ..],
// a[2] = A[16 w + g][16 + 4 t ..], a[3] = A[16 w + g + 8][16 + 4 t ..];
// its sums are those of wgmma_s8 above.
inline void wgmma_s8_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t b,
                        int accumulate) {
  const int wgi = threadIdx.x >> 7, tid = threadIdx.x & 127;
  WarpgroupFragments& f = g_wg_frag[wgi];
  for (int i = 0; i < 4; ++i) f.a[tid][i] = a[i];
  g_warpgroup_barrier[wgi]->arrive_and_wait();
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  int arow[2][32], bcol[16][32];
  for (int h = 0; h < 2; ++h)        // A rows 16 warp + g + 8 h
    for (int k = 0; k < 32; ++k) {
      const int src = warp * 32 + g * 4 + (k % 16) / 4;
      arow[h][k] = emu_s8(f.a[src][h + 2 * (k / 16)], k % 4);
    }
  for (int n = 0; n < 16; ++n)       // B rows 8 (n / 2) + 2 t + n % 2
    for (int k = 0; k < 32; ++k)
      bcol[n][k] = emu_operand(b, 8 * (n / 2) + 2 * t + n % 2, k);
  for (int i = 0; i < 32; ++i) {
    const int* ar = arow[(i / 2) % 2];
    const int* bc = bcol[2 * (i / 4) + i % 2];
    uint32_t sum = 0;
    for (int k = 0; k < 32; ++k) sum += static_cast<uint32_t>(ar[k] * bc[k]);
    d[i] = static_cast<int>((accumulate ? static_cast<uint32_t>(d[i]) : 0u) + sum);
  }
  g_warpgroup_barrier[wgi]->arrive_and_wait();   // f is read: it may be reused
}

inline int make_tensor_map(CUtensorMap* map, const void* base, int rank,
                           const uint64_t* dims, const uint64_t* strides,
                           const uint32_t* box) {
  if ((box[0] != 128 && box[0] != 64) || rank < 2 || rank > 3) return 1;
  map->base = static_cast<const unsigned char*>(base);
  map->rank = rank;
  for (int i = 0; i < rank; ++i) {
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    if (i + 1 < rank) map->strides[i] = strides[i];
  }
  return 0;
}
inline int sm_count() { return g_emu_sm_count; }

}  // namespace hopper
