// Inverse NTT + CRT lift + accumulator add, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel zig_tfhe_tpu/ops/pallas/ntt_inverse.py:
// ntt_inverse_to_crt_pallas (Pallas body `_kernel`).  One launch finishes
// one blind-rotation step:
//
//   for each CRT prime p:
//     lo, hi = int8 limbs of the residues v_p          (v == lo + 256*hi)
//     z_lo   = [lo | hi] @ limb_lo([Minv ; 256*Minv mod p])   int8 MMA, s32
//     z_hi   = [lo | hi] @ limb_hi([Minv ; 256*Minv mod p])
//     x_p    = barrett(z_lo + 256*barrett(z_hi))
//     sum   += x_p * e_p  (uint32, wraps mod 2^32)
//     frac  += x_p * theta_p  (f32, in prime order, no FMA contraction)
//   out = acc + ((sum - rint(frac) * P_mod) << drop)      (uint32 wrap)
//
// This is the "concat" formulation of zig_tfhe_tpu/ops/ntt.py:
// ntt_inverse_to_crt, so x_p is bit-equal to the plain PyTorch version
// (zig_tfhe_tpu_torch/ops/ntt.py) and the output is bit-equal to both.
//
// Bound on this card.  At the 128-bit default (P = 3 primes, N = 1024) and
// B = 2048 gates, one step is 2B x N outputs x 2N depth x 2 matrices x P =
// 51.5 G int8 MACs (about 52 us at the 1,979 TOPS int8 data-sheet rate)
// against about 94 MB moved (residues 50 MB, acc and out 34 MB, matrices
// 12 MB: about 28 us at 3.35 TB/s), so the step is tensor-core bound once
// it runs on the tensor cores.
//
// Design.  The Pallas grid was (batch tiles x primes) with the CRT sums
// carried in VMEM from one grid step to the next; blocks on the card run in
// no order, so here each block owns a BM x BN tile of the output and loops
// over the primes itself, keeping the uint32 CRT sum and the f32 fraction
// of its outputs in registers; the epilogue (- m*P_mod, << drop, + acc)
// runs in the same block.  The int8 limb split of the residues happens
// while they are staged into shared memory, so neither the limb planes nor
// any per-prime partial ever reaches device memory.  The inverse matrices
// (12 MB per step) stay resident in the 50 MB L2.  The MMAs are
// mma.sync.m16n8k32 s8 tiles; stages are loaded synchronously.  wgmma,
// TMA and a multi-stage pipeline are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPrimes = 8;
constexpr int BM = 128;        // output rows (of 2B) per block
constexpr int BN = 64;         // output columns (of N) per block
constexpr int BK = 64;         // contraction chunk (of N) per stage
constexpr int LDS = BK + 16;   // shared row stride in bytes: 20 words keeps
                               // the 8 fragment rows of a warp on 8
                               // disjoint 4-bank groups (no conflicts)
constexpr int kThreads = 256;  // 8 warps: 4 along rows x 2 along columns,
                               // each owning a 32 x 32 output tile

struct CrtParams {
  int p[kMaxPrimes];
  uint32_t e[kMaxPrimes];      // CRT idempotent mod 2^32
  float inv_p[kMaxPrimes];     // np.float32(1 / p)
  float theta[kMaxPrimes];     // np.float32(e_p / P)
  uint32_t p_mod;              // P mod 2^32
  int n_primes;
};

// round(f32(x) * f32(1/p)) half to even, as jnp.round; r = x - q*p wraps
__device__ __forceinline__ int barrett(int x, int p, float inv_p) {
  const int q = __float2int_rn(__fmul_rn(__int2float_rn(x), inv_p));
  return static_cast<int>(static_cast<uint32_t>(x) -
                          static_cast<uint32_t>(q) * static_cast<uint32_t>(p));
}

// 4 residues -> packed int8 lo limbs and hi limbs (little-endian bytes)
__device__ __forceinline__ void split_limbs(int4 x, uint32_t& lo, uint32_t& hi) {
  const int v[4] = {x.x, x.y, x.z, x.w};
  lo = 0;
  hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int l = ((v[j] + 128) & 255) - 128;
    const int h = (v[j] - l) >> 8;
    lo |= (static_cast<uint32_t>(l) & 0xFFu) << (8 * j);
    hi |= (static_cast<uint32_t>(h) & 0xFFu) << (8 * j);
  }
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

// v:    int32 [P, rows, N]   per-prime residues, |v| <= 0.55p
// acc:  int32 [rows, N]      accumulator (rows = 2B: the (B, 2) axes)
// out:  int32 [rows, N]
// m_lo, m_hi: int8 [P, N, 2N]  limbs of [Minv ; 256*Minv mod p],
//             transposed so the contraction axis is contiguous
__global__ void __launch_bounds__(kThreads)
ntt_inverse_crt_acc_kernel(const int* __restrict__ v, const int* __restrict__ acc,
                           int* __restrict__ out, const int8_t* __restrict__ m_lo,
                           const int8_t* __restrict__ m_hi, CrtParams cp,
                           int rows, int N, int drop) {
  __shared__ __align__(16) int8_t a_lo[BM * LDS];
  __shared__ __align__(16) int8_t a_hi[BM * LDS];
  // B tiles [BN][BK]: 0 lo-limb rows k, 1 lo-limb rows N+k,
  //                   2 hi-limb rows k, 3 hi-limb rows N+k
  __shared__ __align__(16) int8_t b_s[4][BN * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  uint32_t crt_sum[2][4][4];
  float crt_frac[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        crt_sum[mt][nt][i] = 0u;
        crt_frac[mt][nt][i] = 0.0f;
      }

  for (int pi = 0; pi < cp.n_primes; ++pi) {
    const int* vp = v + static_cast<size_t>(pi) * rows * N;
    const int8_t* lo_t = m_lo + static_cast<size_t>(pi) * N * 2 * N;
    const int8_t* hi_t = m_hi + static_cast<size_t>(pi) * N * 2 * N;
    int zlo[2][4][4], zhi[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          zlo[mt][nt][i] = 0;
          zhi[mt][nt][i] = 0;
        }

    for (int k0 = 0; k0 < N; k0 += BK) {
      __syncthreads();  // the previous stage's fragments are consumed
      // residues -> limb planes: BM rows x BK int32, 16 B per thread load
#pragma unroll
      for (int it = 0; it < (BM * BK / 4) / kThreads; ++it) {
        const int idx = tid + it * kThreads;
        const int r = idx / (BK / 4);
        const int c4 = idx % (BK / 4);
        int4 x = make_int4(0, 0, 0, 0);
        if (row0 + r < rows)
          x = *reinterpret_cast<const int4*>(
              vp + static_cast<size_t>(row0 + r) * N + k0 + c4 * 4);
        uint32_t lo, hi;
        split_limbs(x, lo, hi);
        *reinterpret_cast<uint32_t*>(a_lo + r * LDS + c4 * 4) = lo;
        *reinterpret_cast<uint32_t*>(a_hi + r * LDS + c4 * 4) = hi;
      }
      {  // matrix tiles: BN rows x BK bytes each, one 16 B load per tile
        const int r = tid / (BK / 16);
        const int c = tid % (BK / 16);
        const size_t top = static_cast<size_t>(col0 + r) * 2 * N + k0 + c * 16;
        const size_t bot = top + N;
        const int so = r * LDS + c * 16;
        *reinterpret_cast<int4*>(&b_s[0][so]) = *reinterpret_cast<const int4*>(lo_t + top);
        *reinterpret_cast<int4*>(&b_s[1][so]) = *reinterpret_cast<const int4*>(lo_t + bot);
        *reinterpret_cast<int4*>(&b_s[2][so]) = *reinterpret_cast<const int4*>(hi_t + top);
        *reinterpret_cast<int4*>(&b_s[3][so]) = *reinterpret_cast<const int4*>(hi_t + bot);
      }
      __syncthreads();

#pragma unroll
      for (int ks = 0; ks < BK; ks += 32) {
        uint32_t alo[2][4], ahi[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int o = (wm * 32 + mt * 16 + g) * LDS + ks + t * 4;
          alo[mt][0] = lds32(a_lo + o);
          alo[mt][1] = lds32(a_lo + o + 8 * LDS);
          alo[mt][2] = lds32(a_lo + o + 16);
          alo[mt][3] = lds32(a_lo + o + 8 * LDS + 16);
          ahi[mt][0] = lds32(a_hi + o);
          ahi[mt][1] = lds32(a_hi + o + 8 * LDS);
          ahi[mt][2] = lds32(a_hi + o + 16);
          ahi[mt][3] = lds32(a_hi + o + 8 * LDS + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int o = (wn * 32 + nt * 8 + g) * LDS + ks + t * 4;
          const uint32_t lt0 = lds32(&b_s[0][o]), lt1 = lds32(&b_s[0][o + 16]);
          const uint32_t lb0 = lds32(&b_s[1][o]), lb1 = lds32(&b_s[1][o + 16]);
          const uint32_t ht0 = lds32(&b_s[2][o]), ht1 = lds32(&b_s[2][o + 16]);
          const uint32_t hb0 = lds32(&b_s[3][o]), hb1 = lds32(&b_s[3][o + 16]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_s8(zlo[mt][nt], alo[mt], lt0, lt1);
            mma_s8(zlo[mt][nt], ahi[mt], lb0, lb1);
            mma_s8(zhi[mt][nt], alo[mt], ht0, ht1);
            mma_s8(zhi[mt][nt], ahi[mt], hb0, hb1);
          }
        }
      }
    }

    // per-prime epilogue: residue recombine + CRT accumulate (registers)
    const int p = cp.p[pi];
    const float inv_p = cp.inv_p[pi];
    const uint32_t e = cp.e[pi];
    const float theta = cp.theta[pi];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int y = static_cast<int>(
              static_cast<uint32_t>(zlo[mt][nt][i]) +
              static_cast<uint32_t>(barrett(zhi[mt][nt][i], p, inv_p)) * 256u);
          const int x = barrett(y, p, inv_p);
          crt_sum[mt][nt][i] += static_cast<uint32_t>(x) * e;
          crt_frac[mt][nt][i] = __fadd_rn(crt_frac[mt][nt][i],
                                          __fmul_rn(__int2float_rn(x), theta));
        }
  }

  // final epilogue: out = acc + ((sum - m * P_mod) << drop)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm * 32 + mt * 16 + g + 8 * h;
        if (r >= rows) continue;
        const int c = col0 + wn * 32 + nt * 8 + t * 2;
        const size_t o = static_cast<size_t>(r) * N + c;
        const int2 a = *reinterpret_cast<const int2*>(acc + o);
        uint32_t res[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 2 * h + j;
          const uint32_t m = static_cast<uint32_t>(__float2int_rn(crt_frac[mt][nt][i]));
          const uint32_t delta = (crt_sum[mt][nt][i] - m * cp.p_mod) << drop;
          res[j] = static_cast<uint32_t>(j ? a.y : a.x) + delta;
        }
        *reinterpret_cast<int2*>(out + o) =
            make_int2(static_cast<int>(res[0]), static_cast<int>(res[1]));
      }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
// The caller guarantees: device pointers of the stated shapes, contiguous,
// 16-byte aligned; N % 64 == 0; 1 <= n_primes <= 8; 0 <= drop < 32.
extern "C" int ztfhe_ntt_inverse_crt_acc(
    const int* v, const int* acc, int* out, const int8_t* m_lo,
    const int8_t* m_hi, const int* primes, const int* crt_e,
    const float* inv_p, const float* theta, int p_mod, int n_primes,
    int rows, int N, int drop, void* stream) {
  if (n_primes < 1 || n_primes > kMaxPrimes || rows < 1 || N < BN ||
      N % BN != 0 || N % BK != 0 || drop < 0 || drop > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  CrtParams cp;
  for (int i = 0; i < kMaxPrimes; ++i) {
    const bool live = i < n_primes;
    cp.p[i] = live ? primes[i] : 1;
    cp.e[i] = live ? static_cast<uint32_t>(crt_e[i]) : 0u;
    cp.inv_p[i] = live ? inv_p[i] : 1.0f;
    cp.theta[i] = live ? theta[i] : 0.0f;
  }
  cp.p_mod = static_cast<uint32_t>(p_mod);
  cp.n_primes = n_primes;
  const dim3 grid(N / BN, (rows + BM - 1) / BM);
  ntt_inverse_crt_acc_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      v, acc, out, m_lo, m_hi, cp, rows, N, drop);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ztfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
