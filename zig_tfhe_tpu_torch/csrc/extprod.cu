// Toeplitz external-product contraction for one digit limb, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel zig_tfhe_tpu/ops/pallas/extprod.py:
// extprod_matmul_pallas (Pallas body `_kernel`).  One launch computes
//
//   out[b, o*N + n] = sum_kl 2^(8*(kl+drop)) *
//                     sum_j sum_k d[b, j*N + k] * ext[kl, j, o, (n - k) mod 2N]
//
// mod 2^32 (drop = 4 - n_kl): the gadget digits d int8 [B, 2L*N] against
// the negacyclic circulant of every ext row int8 [n_kl, 2L, 2, 2N] of one
// BSK entry.  ext already holds [p, -p], so the circulant needs no sign
// logic.  Each key limb's partial is an exact int32 (2L*N * |d| * 128 <
// 2^31, checked by the wrapper); the shifts and the sum over key limbs run
// in uint32 (signed overflow is undefined in C++), so the output is exact
// mod 2^32 and bit-equal to the plain PyTorch version.
//
// Bound on this card.  At SECURITY_128_BIT (N = 1024, L = 3, 4 key limbs)
// and B = 2048 gates, one call is B x 2N outputs x 2L*N depth x 4 limbs =
// 103 G int8 MACs (206 G operations: about 104 us at the 1,979 TOPS int8
// data-sheet rate) against about 29 MB moved (digits 12.6 MB, output
// 16.8 MB, key 0.1 MB: about 9 us at 3.35 TB/s): operations bound it.
//
// Design.  The TPU kernel built the whole [N, 2N] circulant of each ext
// row in VMEM by log2 N slice-and-concat doublings (Mosaic could not lower
// an int8 roll) and ran one big dot per (key limb, row).  Here no circulant
// exists in memory: a block owns BM rows x BN output columns (within one
// component o), and for a contraction chunk [k0, k0+BK) of row j those
// columns read only the window ext[(n0 - k0 - BK + 1 .. n0 + BN - 1 - k0)
// mod 2N].  The block stages, once per row j, the window of the whole row
// (N + BN - 1 entries) REVERSED in shared memory, rev[t] = ext[(n0 + BN -
// 1 - t) mod 2N], so that the 4 k-consecutive bytes a lane of
// mma.sync.m16n8k32 holds for one column, ext[n-k], ext[n-k-1], ..., are
// ascending and contiguous in rev.  Their offset modulo 4 is fixed per
// lane, so the window is kept as 4 copies shifted by 0..3 bytes (built
// with __byte_perm from two aligned words) and every B fragment is one
// aligned 32-bit shared load; the copies' word stride (== 8 mod 32) keeps
// the loads of a warp on distinct banks.  Along the Toeplitz diagonal the
// fragments of the 4 column tiles and 2 k-steps of a chunk are 10
// distinct words per key limb, loaded once and reused.  The key limbs are
// the innermost loop: each A fragment (the digits, staged per chunk in
// shared memory) feeds all n_kl products, and each key limb keeps its own
// int32 accumulators in registers until the uint32 epilogue.  Stages are
// loaded synchronously; wgmma, TMA and a pipeline are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output rows (of B) per block
constexpr int BN = 64;         // output columns (of 2N) per block
constexpr int BK = 64;         // contraction chunk (of N) per stage
constexpr int LDS = BK + 16;   // digit row stride in shared memory (bytes):
                               // 20 words keeps the 8 fragment rows of a
                               // warp on 8 disjoint 4-bank groups
constexpr int kThreads = 256;  // 8 warps: 4 along rows x 2 along columns,
                               // each owning a 32 x 32 output tile
constexpr int kMaxN = 1024;
constexpr int kMaxKl = 4;

// words per shifted window copy: (N + BN) / 4, rounded up to == 8 mod 32
__host__ __device__ constexpr int win_words(int N) {
  return (N + BN) / 4 + ((8 - (N + BN) / 4 % 32) + 32) % 32;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// dig: int8 [B, rows2l*N]      one digit limb (rows2l = 2L gadget rows)
// ext: int8 [NKL, rows2l, 2, 2N] one BSK step in ext-limb form
// out: int32 [B, 2N]
template <int NKL>
__global__ void __launch_bounds__(kThreads)
extprod_matmul_kernel(const int8_t* __restrict__ dig,
                      const int8_t* __restrict__ ext, int* __restrict__ out,
                      int B, int rows2l, int N) {
  __shared__ __align__(16) int8_t a_s[BM * LDS];
  // win[(kl * 4 + r) * ww + u] = rev[r + 4u .. r + 4u + 3] of key limb kl
  __shared__ __align__(16) uint32_t win[NKL * 4 * win_words(kMaxN)];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;         // in [0, 2N)
  const int o = col0 / N, n0 = col0 % N;
  const int K = rows2l * N;
  const int ww = win_words(N);
  const int row_words = N / 2;              // 2N bytes of an ext row
  const int base_word = (n0 + BN - 4) / 4;  // holds ext[n0+BN-4 .. n0+BN-1]

  // Lane (g, t) of column tile nt reads, at k-step ks of a chunk, the
  // bytes rev[s .. s+3] with s = k0 + 32ks + 4t - c + BN - 1 and c = wn*32
  // + nt*8 + g; b1 reads s + 16.  So s == r (mod 4) with r fixed per lane,
  // and the chunk needs the words at s = s_lane + 8i - 24, i = 0..9, of
  // copy r: word q_lane + k0/4 + 2i.
  const int r = (BN - 1 - g) & 3;
  const int q_lane = (4 * t - wn * 32 - g + BN - 1 - 24 - r) / 4;

  int acc[NKL][2][4][4];
#pragma unroll
  for (int kl = 0; kl < NKL; ++kl)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[kl][mt][nt][i] = 0;

  for (int j = 0; j < rows2l; ++j) {
    for (int k0 = 0; k0 < N; k0 += BK) {
      __syncthreads();  // the previous stage's fragments are consumed
      if (k0 == 0) {
        // row j's reversed window, 4 shifted copies per key limb:
        // rev word u = byte-reverse(ext word (base_word - u) mod row_words)
        for (int idx = tid; idx < NKL * 4 * ww; idx += kThreads) {
          const int u = idx % ww;
          const int sh = (idx / ww) & 3;
          const int kl = idx / (4 * ww);
          const uint32_t* e = reinterpret_cast<const uint32_t*>(
              ext + ((static_cast<size_t>(kl) * rows2l + j) * 2 + o) * 2 * N);
          const int w0 = ((base_word - u) % row_words + row_words) % row_words;
          const int w1 = (w0 + row_words - 1) % row_words;
          const uint32_t lo = __byte_perm(e[w0], 0u, 0x0123);
          const uint32_t hi = __byte_perm(e[w1], 0u, 0x0123);
          win[idx] = __byte_perm(lo, hi, 0x3210 + 0x1111 * sh);
        }
      }
      // digits: BM rows x BK bytes of columns j*N + k0, 16 B per load
#pragma unroll
      for (int it = 0; it < (BM * BK / 16) / kThreads; ++it) {
        const int idx = tid + it * kThreads;
        const int rr = idx / (BK / 16);
        const int c16 = idx % (BK / 16);
        int4 x = make_int4(0, 0, 0, 0);
        if (row0 + rr < B)
          x = *reinterpret_cast<const int4*>(
              dig + static_cast<size_t>(row0 + rr) * K + j * N + k0 + c16 * 16);
        *reinterpret_cast<int4*>(a_s + rr * LDS + c16 * 16) = x;
      }
      __syncthreads();

      uint32_t a[2][2][4];  // [k-step][row tile]
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int so = (wm * 32 + mt * 16 + g) * LDS + ks * 32 + t * 4;
          a[ks][mt][0] = lds32(a_s + so);
          a[ks][mt][1] = lds32(a_s + so + 8 * LDS);
          a[ks][mt][2] = lds32(a_s + so + 16);
          a[ks][mt][3] = lds32(a_s + so + 8 * LDS + 16);
        }
#pragma unroll
      for (int kl = 0; kl < NKL; ++kl) {
        const uint32_t* wr = win + (kl * 4 + r) * ww + q_lane + k0 / 4;
        uint32_t v[10];
#pragma unroll
        for (int i = 0; i < 10; ++i) v[i] = wr[2 * i];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t b0 = v[4 * ks - nt + 3], b1 = v[4 * ks - nt + 5];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_s8(acc[kl][mt][nt], a[ks][mt], b0, b1);
          }
      }
    }
  }

  // epilogue: sum over key limbs of partial << 8*(kl + drop), in uint32
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm * 32 + mt * 16 + g + 8 * h;
        if (row >= B) continue;
        const int c = col0 + wn * 32 + nt * 8 + t * 2;
        uint32_t res[2] = {0u, 0u};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int kl = 0; kl < NKL; ++kl)
            res[jj] += static_cast<uint32_t>(acc[kl][mt][nt][2 * h + jj])
                       << (8 * (kl + kMaxKl - NKL));
        *reinterpret_cast<int2*>(out + static_cast<size_t>(row) * 2 * N + c) =
            make_int2(static_cast<int>(res[0]), static_cast<int>(res[1]));
      }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
// The caller guarantees: device pointers of the stated shapes, contiguous,
// 16-byte aligned; N % 64 == 0, N <= 1024; 1 <= n_kl <= 4.
extern "C" int ztfhe_extprod_matmul(const int8_t* dig, const int8_t* ext,
                                    int* out, int B, int rows2l, int N,
                                    int n_kl, void* stream) {
  if (B < 1 || rows2l < 1 || N < BN || N % BN != 0 || N % BK != 0 ||
      N > kMaxN || n_kl < 1 || n_kl > kMaxKl)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(2 * N / BN, (B + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_kl) {
    case 1: extprod_matmul_kernel<1><<<grid, kThreads, 0, s>>>(dig, ext, out, B, rows2l, N); break;
    case 2: extprod_matmul_kernel<2><<<grid, kThreads, 0, s>>>(dig, ext, out, B, rows2l, N); break;
    case 3: extprod_matmul_kernel<3><<<grid, kThreads, 0, s>>>(dig, ext, out, B, rows2l, N); break;
    default: extprod_matmul_kernel<4><<<grid, kThreads, 0, s>>>(dig, ext, out, B, rows2l, N); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ztfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
