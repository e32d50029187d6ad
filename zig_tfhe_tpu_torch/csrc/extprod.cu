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
// 2^31, checked by the wrapper) kept in its own accumulators; the shifts
// and the sum over key limbs run in uint32 (signed overflow is undefined in
// C++), so the output is exact mod 2^32 and bit-equal to the plain PyTorch
// version, whatever wgmma does with an overflowing sum (none overflows).
//
// Bound on this card.  At SECURITY_128_BIT (N = 1024, L = 3, 4 key limbs)
// and B = 2048 gates, one call is B x 2N outputs x 2L*N depth x 4 limbs =
// 103 G int8 MACs (206 G operations: about 104 us at the 1,979 TOPS int8
// data-sheet rate) against about 29 MB moved (digits 12.6 MB, output
// 16.8 MB, key 0.1 MB: about 9 us at 3.35 TB/s): operations bound it.
//
// Design.  The product is transposed: the accumulator tile is [output
// columns x batch lanes], so the circulant is the A operand of
// wgmma.m64n64k32.s32.s8.s8 and lives only in registers, and the digits
// are the B operand as they lie in memory (rows of B = batch lanes, the
// contraction contiguous: K-major).  A block is one producer warpgroup and
// two consumer warpgroups; it owns 64 batch lanes and 128 output columns,
// 64 per consumer warpgroup, each inside one component o (also at N = 64,
// where the block's two tiles are o = 0 and o = 1).
//
// - Digits: one producer thread keeps a ring of kStages stages full by TMA
//   (a box of 64 lanes x BK bytes, BK = 128 with the 128-byte swizzle when
//   N % 128 == 0, else 64 with the 64-byte one; lanes past B are zero-
//   filled), `full` mbarriers by bytes, `empty` by one arrival per
//   consumer warpgroup once its wgmma groups on the stage have retired.
//   Both consumer warpgroups read every stage.
// - Circulant.  Consumer row c (of 64 columns from n0) at contraction k of
//   key row j reads ext[(n0 + c - k) mod 2N].  Kept REVERSED in shared
//   memory, rev[s] = ext[(n0 + 63 - s) mod 2N] for s in [0, N + 64), the 4
//   k-consecutive bytes of an A register (PTX register layout, see
//   hopper_prims.cuh) are 4 ascending bytes rev[s .. s+3], s = 63 - c + k;
//   s mod 4 is fixed per lane, so rev is kept as 4 copies shifted by 0..3
//   bytes and every A register is one aligned 32-bit shared load (the
//   copies' word stride == 8 mod 32 puts a warp's loads on distinct banks,
//   or the same word).  The circulant itself is never stored anywhere.
// - Windows are built at the row boundary by each consumer warpgroup
//   itself (its own 64 columns, all key limbs), into the other of two
//   buffers, while its last wgmma groups of the previous row still run;
//   one named barrier over the warpgroup per row.  (Built one row ahead
//   by the producer warpgroup's three spare warps instead, the kernel took
//   320 us at B = 2048 against 206 us: PERF.md.)
// - Consumers: per 32-byte k-step, 4 A registers per key limb from the
//   window, then one wgmma per key limb into that limb's 32 int32
//   accumulators (4 limbs: 128 registers), one commit group per k-step.
//   The A fragments alternate between two register sets: a set is written
//   again only after wait_group 1 has retired the group that read it.
// - Epilogue: the uint32 shift-and-sum over key limbs in registers, the
//   [lanes x columns] tile through shared memory, and every row of `out`
//   stored in 16-byte pieces.
//
// Per block and k-step a consumer warpgroup loads 8 KB of A fragments and
// its 4 wgmmas read the 2 KB digit tile 4 times: at the tensor cores' rate
// the two warpgroups would want the SM's whole shared-memory bandwidth
// (128 B/clock).  Measured on an NVIDIA H100 80GB HBM3 at 700 W the call
// takes ~206-221 us at B = 2048, and neither shared memory nor the tensor
// cores set that pace: each warpgroup's issue-to-retire chain of N = 64
// wgmmas does (~550 clocks a k-step for 128 clocks of tensor work;
// PERF.md).  L2 -> SM: the digits once per 128 columns (2N/128 = 16 times
// at N = 1024: 201 MB at B = 2048).

#include "hopper_prims.cuh"

namespace {

using namespace hopper;

constexpr int BM = 64;          // output columns per consumer warpgroup (wgmma M)
constexpr int BL = 64;          // batch lanes per block (wgmma N)
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 6;
constexpr int LDE = BM + 4;     // epilogue row stride (words): 2 * LDE == 8
                                // mod 32 puts the 32 writes of a warp on
                                // 32 banks
constexpr int kMaxN = 1024;
constexpr int kMaxKl = 4;

// words per shifted window copy: (N + BM) / 4, rounded up to == 8 mod 32
__host__ __device__ constexpr int win_words(int N) {
  return (N + BM) / 4 + ((8 - (N + BM) / 4 % 32) + 32) % 32;
}

__host__ __device__ constexpr int smem_bytes(int N, int nkl, int bk) {
  return 1024 + kStages * BL * bk                       // digit ring
         + 2 * kConsumers * nkl * 4 * win_words(N) * 4  // two rows' windows
         + kConsumers * BL * LDE * 4                    // epilogue tiles
         + 2 * kStages * 8;                             // mbarriers
}

// map_d: int8 [B, rows2l*N]  one digit limb (rows2l = 2L gadget rows),
//                            box [64 lanes, BK bytes]
// ext:   int8 [NKL, rows2l, 2, 2N]  one BSK step in ext-limb form
// out:   int32 [B, 2N]
template <int NKL, int BK>
__global__ void __launch_bounds__(kThreads, 1)
extprod_matmul_kernel(const __grid_constant__ CUtensorMap map_d,
                      const int8_t* __restrict__ ext, int* __restrict__ out,
                      int B, int rows2l, int N) {
  constexpr int KSTEPS = BK / 32;   // wgmma k-steps per stage (even)
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = align_1024(smem);
  const int ww = win_words(N);
  const int win_set = NKL * 4 * ww;   // one warpgroup's windows of one row
  // win[((row % 2) * kConsumers + wg) * win_set + (kl * 4 + shift) * ww + u]
  //   = rev[shift + 4u .. shift + 4u + 3] of key limb kl
  uint32_t* win = reinterpret_cast<uint32_t*>(ring + kStages * BL * BK);
  int* epi = reinterpret_cast<int*>(win + 2 * kConsumers * win_set);
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + kConsumers * BL * LDE);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane0 = blockIdx.y * BL;
  const int col0 = blockIdx.x * (kConsumers * BM);   // in [0, 2N)
  const int nk = N / BK;                             // stages per key row

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    reg_dec<40>();
    if (tid == kConsumers * 128) {
      // -- producer: one thread keeps the digit ring full -------------------
      int s = 0;
      uint32_t ph = 1;   // the ring starts empty: the first waits pass
      for (int j = 0; j < rows2l; ++j)
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(empty + s, ph);
          mbar_arrive_expect_tx(full + s, BL * BK);
          tma_load_2d(ring + s * BL * BK, &map_d, j * N + kc * BK, lane0,
                      full + s);
          if (++s == kStages) {
            s = 0;
            ph ^= 1u;
          }
        }
    }
  } else {
    // -- consumers: 64 columns x 64 lanes x NKL key limbs each --------------
    reg_inc<232>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bool elected = (tid & 127) == 0;
    // Register (h, kh) of k-step k holds rev[s .. s+3], s = 63 - c + k + 16
    // kh + 4t with c = 16 warp + g + 8h: copy r = (63 - g) % 4, word
    // q_lane + k/4 - 2h + 4kh.
    const int r = (BM - 1 - g) & 3;
    const int q_lane = (BM - 1 - g) / 4 - 4 * warp + t;
    // rev word u = byte-reverse(ext word (base_word - u) mod row_words),
    // base_word holding ext[n0 + 60 .. n0 + 63]
    const int o = (col0 + wg * BM) / N, n0 = (col0 + wg * BM) % N;
    const int base_word = (n0 + BM - 4) / 4;
    const int row_words = N / 2;   // 2N bytes of an ext row
    int acc[NKL][32];
    uint32_t frag[2][NKL][4];
    int s = 0, pending = -1;
    uint32_t ph = 0;
    for (int j = 0; j < rows2l; ++j) {
      // row j's reversed windows, 4 shifted copies per key limb, into the
      // buffer row j - 2 used: every thread's loads of that row came before
      // the barrier of row j - 1
      uint32_t* wb = win + ((j & 1) * kConsumers + wg) * win_set;
      for (int idx = tid & 127; idx < NKL * ww; idx += 128) {
        const int u = idx % ww, kl = idx / ww;
        const uint32_t* e = reinterpret_cast<const uint32_t*>(
            ext + ((static_cast<size_t>(kl) * rows2l + j) * 2 + o) * 2 * N);
        const int w0 = ((base_word - u) % row_words + row_words) % row_words;
        const int w1 = (w0 + row_words - 1) % row_words;
        const uint32_t lo = __byte_perm(e[w0], 0u, 0x0123);
        const uint32_t hi = __byte_perm(e[w1], 0u, 0x0123);
#pragma unroll
        for (int sh = 0; sh < 4; ++sh)
          wb[(kl * 4 + sh) * ww + u] = __byte_perm(lo, hi, 0x3210 + 0x1111 * sh);
      }
      named_barrier_sync(1 + wg, 128);   // row j's windows are built
      const uint32_t* wrow = wb + r * ww + q_lane;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(full + s, ph);
        const uint64_t db = make_desc<BK>(ring + s * BL * BK);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          uint32_t (&fr)[NKL][4] = frag[ks & 1];
          const uint32_t* p = wrow + (kc * BK + 32 * ks) / 4;
#pragma unroll
          for (int kl = 0; kl < NKL; ++kl) {
            const uint32_t* q = p + kl * 4 * ww;
            fr[kl][0] = q[0];
            fr[kl][1] = q[-2];
            fr[kl][2] = q[4];
            fr[kl][3] = q[2];
            fence_acc(fr[kl]);
          }
          const int accumulate = (j | kc | ks) != 0;
#pragma unroll
          for (int kl = 0; kl < NKL; ++kl) fence_acc(acc[kl]);
          wgmma_fence();
#pragma unroll
          for (int kl = 0; kl < NKL; ++kl)
            wgmma_s8_rs(acc[kl], fr[kl], db + 2 * ks, accumulate);
          wgmma_commit();
          wgmma_wait<1>();
          if (ks == 0) {
            // the previous stage's last group has retired
            if (pending >= 0 && elected) mbar_arrive(empty + pending);
            pending = s;
          }
        }
        if (++s == kStages) {
          s = 0;
          ph ^= 1u;
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kl = 0; kl < NKL; ++kl) fence_acc(acc[kl]);

    // epilogue: sum over key limbs of partial << 8*(kl + drop), in uint32,
    // through shared memory [lanes][columns] so rows are stored 16 B at once
    int* ep = epi + wg * BL * LDE;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 16 * warp + g + 8 * ((i >> 1) & 1);
      const int b = 8 * (i >> 2) + 2 * t + (i & 1);
      uint32_t v = 0u;
#pragma unroll
      for (int kl = 0; kl < NKL; ++kl)
        v += static_cast<uint32_t>(acc[kl][i]) << (8 * (kl + kMaxKl - NKL));
      ep[b * LDE + c] = static_cast<int>(v);
    }
    named_barrier_sync(1 + wg, 128);
#pragma unroll
    for (int it = 0; it < BL * BM / 4 / 128; ++it) {
      const int idx = (tid & 127) + 128 * it;
      const int b = idx / (BM / 4), q = idx % (BM / 4);
      if (lane0 + b < B)
        *reinterpret_cast<int4*>(out + static_cast<size_t>(lane0 + b) * 2 * N +
                                 col0 + wg * BM + 4 * q) =
            *reinterpret_cast<const int4*>(ep + b * LDE + 4 * q);
    }
  }
}

template <int NKL, int BK>
int launch(const int8_t* dig, const int8_t* ext, int* out, int B, int rows2l,
           int N, cudaStream_t stream) {
  // the digits change every step: their descriptor is encoded per launch
  CUtensorMap map_d;
  {
    const uint64_t K = static_cast<uint64_t>(rows2l) * N;
    const uint64_t dims[2] = {K, static_cast<uint64_t>(B)};
    const uint64_t strides[1] = {K};
    const uint32_t box[2] = {BK, BL};
    const int e = make_tensor_map(&map_d, dig, 2, dims, strides, box);
    if (e) return e;
  }
  // above 48 KB, dynamic shared memory needs the cap raised (once per
  // device: the call costs host time on a host-bound path)
  thread_local int cap_device = -1;
  int device = 0;
  cudaGetDevice(&device);
  if (device != cap_device) {
    const cudaError_t e = cudaFuncSetAttribute(
        extprod_matmul_kernel<NKL, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(kMaxN, NKL, BK));
    if (e != cudaSuccess) return static_cast<int>(e);
    cap_device = device;
  }
  const dim3 grid(2 * N / (kConsumers * BM), (B + BL - 1) / BL);
  extprod_matmul_kernel<NKL, BK><<<grid, kThreads, smem_bytes(N, NKL, BK), stream>>>(
      map_d, ext, out, B, rows2l, N);
  return static_cast<int>(cudaGetLastError());
}

template <int BK>
int launch_kl(const int8_t* dig, const int8_t* ext, int* out, int B,
              int rows2l, int N, int n_kl, cudaStream_t s) {
  switch (n_kl) {
    case 1: return launch<1, BK>(dig, ext, out, B, rows2l, N, s);
    case 2: return launch<2, BK>(dig, ext, out, B, rows2l, N, s);
    case 3: return launch<3, BK>(dig, ext, out, B, rows2l, N, s);
    default: return launch<4, BK>(dig, ext, out, B, rows2l, N, s);
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
  if (B < 1 || rows2l < 1 || N < BM || N % BM != 0 || N > kMaxN ||
      n_kl < 1 || n_kl > kMaxKl)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N % 128 == 0 ? launch_kl<128>(dig, ext, out, B, rows2l, N, n_kl, s)
                      : launch_kl<64>(dig, ext, out, B, rows2l, N, n_kl, s);
}

extern "C" const char* ztfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
