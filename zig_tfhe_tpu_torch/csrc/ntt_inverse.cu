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
// Input form.  The residues arrive already split: int8 [P, rows, 2N], each
// row [lo(N) | hi(N)], which is the A operand of the product as it stands
// (K2, csrc/ntt_step.cu, writes this form; every |v| <= 32,639, so hi fits
// int8).  That halves the largest stream of the step (2 bytes per residue,
// not 4) and lets TMA stage A without a thread touching it.
//
// Bound on this card.  At the 128-bit default (P = 3 primes, N = 1024) and
// B = 2048 gates (rows = 4096), one step is rows x N outputs x 2N depth x 2
// matrices x P = 51.5 G int8 MACs: 52.1 us at the 1,979 TOPS int8
// data-sheet rate.  Compulsory traffic: residues 25.2 MB, acc and out
// 33.6 MB, matrices 12.6 MB = 71.3 MB, 21.3 us at 3.35 TB/s.  The per-prime
// epilogue is 2 Barretts (each at least an int -> f32 conversion, an f32
// multiply, a rounding and an int32 multiply-subtract), one more rounding,
// 2 f32 operations and 2 int32 multiply-adds per output and prime: about 5
// us over 132 SMs at 1.98 GHz, the roundings split between the f32 -> int
// conversion (16 a clock per SM, measured) and an f32 add
// (chip_smoke.py:_cuda_core_clocks).  So the tensor cores bound it
// (chip_smoke.py computes all three times).
//
// L2 -> SM traffic per call at those shapes.  A block reads its row tile's
// residues for every prime and its column tile's four matrix planes:
//   first version (128 x 64 tiles, int32 residues): 16 column tiles x 50 MB
//     + 32 row tiles x 12.6 MB = 1.2 GB;
//   this version (128 x 64 tiles, int8 limb planes):  16 x 25.2 MB + 32 x
//     12.6 MB = 0.81 GB (0.84 GB with acc and out), i.e. 2/3 of the first
//     version's; measured on an NVIDIA H100 80GB HBM3 at 700 W the call
//     takes 104-109 us, so these bytes arrive at about 8 TB/s and are what
//     the kernel waits for.
// The tile cannot simply grow: every output keeps four 32-bit values in
// registers across the primes (z_lo, z_hi, the CRT sum and the f32
// fraction), so 128 x 64 outputs are 128 registers a thread for two
// consumer warpgroups, and 128 x 128 would be 256.  Sharing each matrix
// tile between the blocks of a cluster (TMA multicast) is the lever left.
//
// Design.  One block owns a 128 x BN tile of the output (BN = 64; 32 when
// 64 would leave SMs without a block, chosen in the entry point from the
// row count) and loops over the primes itself, as before.  Three
// warpgroups: one producer warp and two consumer warpgroups of 64 rows
// each.  The producer's one thread fills a ring of 6 (BN = 64) or 8 stages
// with TMA: per stage 128 contraction bytes of the A tile [128 rows] and of
// both matrix tiles [BN columns], each row 128 bytes, 128-byte swizzled;
// `full` mbarriers carry the byte count, `empty` mbarriers one arrival per
// live consumer warpgroup.  A consumer waits for a stage, issues its 8
// wgmma.m64nBNk32.s8.s8 (4 contraction steps x 2 matrices, both operands
// from shared memory), commits, and releases the stage before it once that
// stage's group has retired (wait_group 1): no __syncthreads in the loop,
// and 5 to 7 stages of loads are in flight while the tensor cores work.
// The per-prime and final epilogues run in registers as in the first
// version, operation for operation.  A warpgroup whose 64 rows lie past the
// end does not run; rows past the end inside a tile are zero-filled by TMA
// and not stored.
//
// The next step's digits (one-limb engine gadgets: every boolean key).  A
// second instance of the kernel (Digits::kRows) also writes the gadget
// digits of the accumulator it has just made, which the next step's K2
// reads as its int8 A tile: for each output u of row (b, c) and each level
// i < levels[c],
//
//   digits[b, c * levels[0] + i, col] =
//       int8(((u + offset[c]) >>u (32 - (i+1) * bits)) & (2^bits - 1))
//       - 2^(bits-1)
//
// which is ops/blind_rotate.py:_decompose_to_rows (ops/decomposition.py:
// gadget_decompose at the engine gadget) followed by the int8 cast of
// ops/cuda/ntt_step.py:digit_planes.  Those two were 11 plain PyTorch
// launches a step, each a pass over the 16 MB accumulator or its digits;
// here the final epilogue holds the values in registers already.  A level
// at a time, each thread stages its two adjacent columns' digits (2 bytes
// a row) in shared memory past the ring, and the warpgroup then stores its
// 64 rows as 16-byte chunks, each row's BN bytes whole.  The compulsory
// traffic of a step grows by the 8.4 MB of digits at B = 2048 (R = 4
// rows): 71.3 -> 79.7 MB, 23.8 us at 3.35 TB/s, so the tensor cores' 52.1
// us still bound it.  Measured on an NVIDIA H100 80GB HBM3 at 700 W (B =
// 2048, calls replayed from a CUDA graph): 98.4 us with the digits against
// 96.2 without at Bg_e 2^7 (2, 2), 99.8 against 96.1 at 2^6 (3, 2).  A
// first version stored each thread's 2 bytes a level straight to global
// memory (8 partial sectors a warp store) and took 125.7 us.  The instance
// without digits is the same machine code as before (`if constexpr`; its
// SASS compared equal line for line).
//
// The split ring's half-rows (the 64-bit torus's hi-plane scan,
// ops/split_ring.py).  There the kernel runs on the views [P, 2B, 2, 2, N]
// and [2B, 2, N] (N = the ring's N/2), so its rows are (b, c, q): the
// component is bit 1 of the row, and the parity q bit 0.  A third instance
// (Digits::kHalfRows) writes the next step's int8 half-rows, which K2s
// (csrc/split_step.cu) reads as its A tile, in (r, q) row order:
//
//   digits[b, 2 * (c * levels[0] + i) + q, col] =
//       int8(((u + offset[c]) >>u (32 - (i+1) * bits)) & (2^bits - 1))
//       - 2^(bits-1)
//
// with offset[c] the hi word of the component's 64-bit offset (its low
// word is carried in the accumulator): ops/split_ring.py:_rows_hi32 and
// the int8 cast, 11 plain PyTorch launches a step before.  A thread's rows
// g + 8h keep bits 0-1 of g, so its component is still uniform and the
// staged 16-byte stores carry over; only the component bit and the digit
// row differ (`component`, `digit_row`).  The two instances above keep
// their machine code (SASS compared equal line for line).
//
// Multi-limb digits (engine gadgets of 9 to 24 bits: every uint key).  K2
// reads such digits as int8 limb planes [B, R * n_dl, N], n_dl = ceil(bits
// / 8), plane r * n_dl + l holding limb l of digit row r = c * levels[0] +
// i, little-endian: ops/decomposition.py:digit_planes of the rows above,
// whose limbs are centred remainders (utils/torus.py:i32_to_i8_limbs).  A
// fourth instance (Digits::kLimbRows) writes them.  With d the digit as
// above, t = d + sum_{k < n_dl - 1} 128 * 2^(8k) makes every lower limb
// a plain byte less 128,
//
//   limb l = ((t >> 8l) & 255) - 128   (l < n_dl - 1),
//   limb n_dl - 1 = t >> 8(n_dl - 1)   (arithmetic: the top limb carries
//                                       the rest),
//
// so a limb's byte is ((t >> 8l) ^ 0x80) & 255 below the top and
// (t >> 8l) & 255 at it.  The limbs sum to d modulo 2^(8 n_dl), and
// exactly for d < 2^(8 n_dl - 1) - bias: every digit of a gadget whose
// bits are not a multiple of 8.  At Bg_e 2^16 and 2^24 the digits d >=
// 2^(bits - 1) - bias wrap (their limbs sum to d - 2^bits), here as in
// digit_planes and the plain engine's limbs (ops/ntt.py:ntt_forward),
// which share engine_digit_limbs.  The ring leaves room to stage one plane of a
// warpgroup's 64 rows, so the planes are staged and stored one limb at a
// time through the same staging rows: n_dl rounds a level.  At uint4
// (Bg_e 2^22, (1, 1), 3 limbs) and B = 2048 that is 12.6 MB of planes a
// step, 3.8 us at 3.35 TB/s, where the decompose and the limb split in
// plain PyTorch took ~12 launches and ~240 us a step.  Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (B = 2048, the cell uint4.lut_b2048's
// trace): 157.2 us a launch with the planes against 155.9 without.  The
// three instances above keep their machine code (SASS compared equal line
// for line).

#include "hopper_prims.cuh"

namespace {

using namespace hopper;

constexpr int kMaxPrimes = 8;
constexpr int BM = 128;         // output rows per block: 2 warpgroups x 64
constexpr int BK = 128;         // contraction bytes per stage (swizzle span)
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);

__host__ __device__ constexpr int stage_bytes(int bn) { return BM * BK + 2 * bn * BK; }
__host__ __device__ constexpr int stages(int bn) { return bn == 64 ? 6 : 8; }
// the digits an instance also writes (see the header): none, the 32-bit
// engine's rows [B, la + lb, N] (rows (b, c)), the split ring's half-rows
// [B, 2 (la + lb), N] (rows (b, c, q)), or the 32-bit engine's limb planes
// [B, (la + lb) n_dl, N] (rows (b, c))
enum class Digits { kNone, kRows, kHalfRows, kLimbRows };

// the digit instances' staging rows: one level of a warpgroup's 64 rows
__host__ __device__ constexpr int stage_row(int bn) { return bn + 16; }
__host__ __device__ constexpr int smem_bytes(int bn, bool digits = false) {
  return 1024 + stages(bn) * stage_bytes(bn) + 2 * stages(bn) * 8 +
         (digits ? kConsumers * 64 * stage_row(bn) : 0);
}

// the gadget of the digits a digit instance writes (see the header)
struct DigitParams {
  uint32_t offset_a, offset_b;   // per component
  uint32_t mask, half;           // 2^bits - 1, 2^(bits-1)
  int bits;                      // 1..8 (one int8 a digit), 9..24 (kLimbRows)
  int la, lb;                    // levels per component
  int limbs;                     // n_dl = ceil(bits / 8)
  uint32_t bias;                 // sum_{k < n_dl - 1} 128 * 2^(8k)
};

struct CrtParams {
  int p[kMaxPrimes];
  uint32_t e[kMaxPrimes];      // CRT idempotent mod 2^32
  float inv_p[kMaxPrimes];     // np.float32(1 / p)
  float theta[kMaxPrimes];     // np.float32(e_p / P)
  uint32_t p_mod;              // P mod 2^32
  int n_primes;
};

// the component of a row: bit 0 on rows (b, c), bit 1 on rows (b, c, q);
// a thread's rows g + 8h keep bits 0-1 of g, so g gives them all
template <Digits D>
__device__ __forceinline__ int component(int row) {
  if constexpr (D == Digits::kHalfRows)
    return (row >> 1) & 1;
  else
    return row & 1;
}

// the digit row of level i of row r, component c, and of its limb l of
// n_dl on the limb planes (see the header)
template <Digits D>
__device__ __forceinline__ size_t digit_row(int r, int c, int i, int la,
                                            int R, int l, int n_dl) {
  if constexpr (D == Digits::kHalfRows)
    return static_cast<size_t>(r >> 2) * (2 * R) + 2 * (c * la + i) + (r & 1);
  else if constexpr (D == Digits::kLimbRows)
    return (static_cast<size_t>(r >> 1) * R + c * la + i) * n_dl + l;
  else
    return static_cast<size_t>(r >> 1) * R + c * la + i;
}

// the byte a digit instance stores of digit d: d itself (one-limb
// instances), or limb l of n_dl of t = d + bias (kLimbRows, see the header)
template <Digits D>
__device__ __forceinline__ uint32_t digit_byte(uint32_t d, int l,
                                               const DigitParams& dp) {
  if constexpr (D == Digits::kLimbRows)
    return ((d + dp.bias) >> (8 * l)) ^ (l + 1 < dp.limbs ? 0x80u : 0u);
  else
    return d;
}

// round(f32(x) * f32(1/p)) half to even, as jnp.round; r = x - q*p wraps
__device__ __forceinline__ int barrett(int x, int p, float inv_p) {
  const int q = __float2int_rn(__fmul_rn(__int2float_rn(x), inv_p));
  return static_cast<int>(static_cast<uint32_t>(x) -
                          static_cast<uint32_t>(q) * static_cast<uint32_t>(p));
}

// map_v:  int8 [P, rows, 2N]   limb planes of the residues, box [1, 128, 128]
// map_lo, map_hi: int8 [P * N, 2N]  limbs of [Minv ; 256*Minv mod p],
//             transposed so the contraction axis is contiguous, box [BN, 128]
// acc, out: int32 [rows, N]    (rows = 2B: the (B, 2) axes; 4B on the split
//                               views: (B, 2, 2))
// digits:   int8 [B, la + lb, N] (kRows), [B, 2 (la + lb), N] (kHalfRows)
//           or [B, (la + lb) n_dl, N] (kLimbRows)
template <int BN, Digits D>
__global__ void __launch_bounds__(kThreads, 1)
ntt_inverse_crt_acc_kernel(const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_lo,
                           const __grid_constant__ CUtensorMap map_hi,
                           const int* __restrict__ acc, int* __restrict__ out,
                           CrtParams cp, int rows, int N, int drop,
                           int8_t* __restrict__ digits, DigitParams dp) {
  constexpr int S = stages(BN);
  constexpr int REGS = BN / 2;   // sums per thread of a 64 x BN tile
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tiles = align_1024(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + S * stage_bytes(BN));
  uint64_t* empty = full + S;
  unsigned char* staging = reinterpret_cast<unsigned char*>(empty + S);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int live = rows - row0 > 64 ? 2 : 1;   // consumer warpgroups with rows
  const int nk = 2 * N / BK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, live);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // -- producer: one thread keeps the ring full ---------------------------
    reg_dec<40>();
    if (tid == kConsumers * 128) {
      int s = 0;
      uint32_t ph = 1;   // the ring starts empty: the first waits pass
      for (int pi = 0; pi < cp.n_primes; ++pi)
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(empty + s, ph);
          unsigned char* st = tiles + s * stage_bytes(BN);
          mbar_arrive_expect_tx(full + s, stage_bytes(BN));
          tma_load_3d(st, &map_v, kc * BK, row0, pi, full + s);
          tma_load_2d(st + BM * BK, &map_lo, kc * BK, pi * N + col0, full + s);
          tma_load_2d(st + BM * BK + BN * BK, &map_hi, kc * BK, pi * N + col0,
                      full + s);
          if (++s == S) {
            s = 0;
            ph ^= 1u;
          }
        }
    }
  } else {
    // -- consumers: 64 rows x BN columns each -------------------------------
    reg_inc<232>();
    if (wg < live) {
      const int lane = tid & 31, warp = (tid >> 5) & 3;
      const int g = lane >> 2, t = lane & 3;
      const bool elected = (tid & 127) == 0;
      uint32_t crt_sum[REGS];
      float crt_frac[REGS];
#pragma unroll
      for (int i = 0; i < REGS; ++i) {
        crt_sum[i] = 0u;
        crt_frac[i] = 0.0f;
      }
      int s = 0;
      uint32_t ph = 0;
      for (int pi = 0; pi < cp.n_primes; ++pi) {
        int zlo[REGS], zhi[REGS];
#pragma unroll
        for (int i = 0; i < REGS; ++i) {
          zlo[i] = 0;
          zhi[i] = 0;
        }
        int pending = -1;   // the stage whose wgmma group is still in flight
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(full + s, ph);
          const unsigned char* st = tiles + s * stage_bytes(BN);
          const uint64_t da = make_desc<BK>(st + wg * 64 * BK);
          const uint64_t dl = make_desc<BK>(st + BM * BK);
          const uint64_t dh = make_desc<BK>(st + BM * BK + BN * BK);
          fence_acc(zlo);
          fence_acc(zhi);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < BK / 32; ++ks) {
            wgmma_s8(zlo, da + 2 * ks, dl + 2 * ks, (kc | ks) != 0);
            wgmma_s8(zhi, da + 2 * ks, dh + 2 * ks, (kc | ks) != 0);
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (pending >= 0 && elected) mbar_arrive(empty + pending);
          pending = s;
          if (++s == S) {
            s = 0;
            ph ^= 1u;
          }
        }
        wgmma_wait<0>();
        fence_acc(zlo);
        fence_acc(zhi);
        if (elected) mbar_arrive(empty + pending);

        // per-prime epilogue: residue recombine + CRT accumulate (registers)
        const int p = cp.p[pi];
        const float inv_p = cp.inv_p[pi];
        const uint32_t e = cp.e[pi];
        const float theta = cp.theta[pi];
#pragma unroll
        for (int i = 0; i < REGS; ++i) {
          const int y = static_cast<int>(
              static_cast<uint32_t>(zlo[i]) +
              static_cast<uint32_t>(barrett(zhi[i], p, inv_p)) * 256u);
          const int x = barrett(y, p, inv_p);
          crt_sum[i] += static_cast<uint32_t>(x) * e;
          crt_frac[i] = __fadd_rn(crt_frac[i],
                                  __fmul_rn(__int2float_rn(x), theta));
        }
      }

      // final epilogue: out = acc + ((sum - m * P_mod) << drop)
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + wg * 64 + warp * 16 + g + 8 * h;
          if (r >= rows) continue;
          const int c = col0 + nt * 8 + t * 2;
          const size_t o = static_cast<size_t>(r) * N + c;
          const int2 a = *reinterpret_cast<const int2*>(acc + o);
          uint32_t res[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int i = nt * 4 + 2 * h + j;
            const uint32_t m = static_cast<uint32_t>(__float2int_rn(crt_frac[i]));
            const uint32_t delta = (crt_sum[i] - m * cp.p_mod) << drop;
            res[j] = static_cast<uint32_t>(j ? a.y : a.x) + delta;
          }
          *reinterpret_cast<int2*>(out + o) =
              make_int2(static_cast<int>(res[0]), static_cast<int>(res[1]));
          if constexpr (D != Digits::kNone) {   // keep u + offset for the digits
            const uint32_t off = component<D>(g) ? dp.offset_b : dp.offset_a;
            crt_sum[nt * 4 + 2 * h] = res[0] + off;
            crt_sum[nt * 4 + 2 * h + 1] = res[1] + off;
          }
        }

      if constexpr (D != Digits::kNone) {
        // The next step's digits, a level (and on the limb planes a limb)
        // at a time.  A thread's rows are all of one component.  Each
        // thread stages its two columns' digits of each row as 2 bytes;
        // then the warpgroup stores its 64 rows from the staging rows as
        // 16-byte chunks, each row's BN bytes contiguous in the digit
        // plane.
        constexpr int SR = stage_row(BN);
        constexpr int CHUNKS = BN / 16;   // 16-byte chunks a row
        unsigned char* st = staging + wg * 64 * SR;
        const int lev = component<D>(g) ? dp.lb : dp.la;
        const int levels = dp.la > dp.lb ? dp.la : dp.lb;
        const int R = dp.la + dp.lb;
        // one plane a round: the digits' one byte, or each of their limbs
        const int n_dl = D == Digits::kLimbRows ? dp.limbs : 1;
        for (int i = 0; i < levels; ++i) {
          const int sh = 32 - (i + 1) * dp.bits;
          for (int l = 0; l < n_dl; ++l) {
            if (i < lev) {
#pragma unroll
              for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int k = nt * 4 + 2 * h;
                  const uint32_t d0 = digit_byte<D>(
                      ((crt_sum[k] >> sh) & dp.mask) - dp.half, l, dp);
                  const uint32_t d1 = digit_byte<D>(
                      ((crt_sum[k + 1] >> sh) & dp.mask) - dp.half, l, dp);
                  *reinterpret_cast<uint16_t*>(
                      st + (warp * 16 + g + 8 * h) * SR + nt * 8 + t * 2) =
                      static_cast<uint16_t>((d0 & 0xFFu) | ((d1 & 0xFFu) << 8));
                }
            }
            named_barrier_sync(1 + wg, 128);
#pragma unroll
            for (int j = 0; j < 64 * CHUNKS / 128; ++j) {
              const int k = (tid & 127) + 128 * j;
              const int rl = k / CHUNKS, part = k % CHUNKS;
              const int r = row0 + wg * 64 + rl;
              const int side = component<D>(rl);
              if (r < rows && i < (side ? dp.lb : dp.la)) {
                const size_t drow = digit_row<D>(r, side, i, dp.la, R, l, n_dl);
                *reinterpret_cast<int4*>(digits + drow * N + col0 + part * 16) =
                    *reinterpret_cast<const int4*>(st + rl * SR + part * 16);
              }
            }
            named_barrier_sync(1 + wg, 128);
          }
        }
      }
    }
  }
}

// the matrix planes are constant per plan: their descriptors are encoded
// once per (pointer, shape) and tile width, and kept (per host thread)
struct MatrixMaps {
  const void* lo = nullptr;
  const void* hi = nullptr;
  int n = 0, primes = 0;
  CUtensorMap map_lo, map_hi;
};

template <int BN, Digits D>
int launch(const int8_t* v, const int* acc, int* out, const int8_t* m_lo,
           const int8_t* m_hi, const CrtParams& cp, int rows, int N, int drop,
           int8_t* digits, const DigitParams& dp, cudaStream_t stream) {
  thread_local MatrixMaps cache;
  MatrixMaps& m = cache;
  const uint64_t k2 = 2 * static_cast<uint64_t>(N);
  if (m.lo != m_lo || m.hi != m_hi || m.n != N || m.primes != cp.n_primes) {
    const uint64_t dims[2] = {k2, static_cast<uint64_t>(cp.n_primes) * N};
    const uint64_t strides[1] = {k2};
    const uint32_t box[2] = {BK, BN};
    int e = make_tensor_map(&m.map_lo, m_lo, 2, dims, strides, box);
    if (!e) e = make_tensor_map(&m.map_hi, m_hi, 2, dims, strides, box);
    if (e) return e;
    m.lo = m_lo;
    m.hi = m_hi;
    m.n = N;
    m.primes = cp.n_primes;
  }
  CUtensorMap map_v;
  {
    const uint64_t dims[3] = {k2, static_cast<uint64_t>(rows),
                              static_cast<uint64_t>(cp.n_primes)};
    const uint64_t strides[2] = {k2, k2 * rows};
    const uint32_t box[3] = {BK, BM, 1};
    const int e = make_tensor_map(&map_v, v, 3, dims, strides, box);
    if (e) return e;
  }
  // above 48 KB, dynamic shared memory needs the cap raised (per device)
  // (set once per device: the call costs host time on a host-bound path)
  constexpr int smem = smem_bytes(BN, D != Digits::kNone);
  thread_local int cap_device = -1;
  int device = 0;
  cudaGetDevice(&device);
  if (device != cap_device) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_inverse_crt_acc_kernel<BN, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap_device = device;
  }
  const dim3 grid(N / BN, (rows + BM - 1) / BM);
  ntt_inverse_crt_acc_kernel<BN, D><<<grid, kThreads, smem, stream>>>(
      map_v, m.map_lo, m.map_hi, acc, out, cp, rows, N, drop, digits, dp);
  return static_cast<int>(cudaGetLastError());
}

template <Digits D>
int entry(const int8_t* v, const int* acc, int* out, const int8_t* m_lo,
          const int8_t* m_hi, const int* primes, const int* crt_e,
          const float* inv_p, const float* theta, int p_mod, int n_primes,
          int rows, int N, int drop, int8_t* digits, const DigitParams& dp,
          void* stream) {
  if (n_primes < 1 || n_primes > kMaxPrimes || rows < 1 || N < 64 ||
      N % 64 != 0 || drop < 0 || drop > 31)
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles64 = (N / 64) * ((rows + BM - 1) / BM);
  return tiles64 >= sm_count()
             ? launch<64, D>(v, acc, out, m_lo, m_hi, cp, rows, N, drop,
                             digits, dp, s)
             : launch<32, D>(v, acc, out, m_lo, m_hi, cp, rows, N, drop,
                             digits, dp, s);
}

// the digit entries' gadget: false where the kernel cannot write it
bool digit_params(DigitParams* dp, int offset_a, int offset_b, int bits,
                  int la, int lb) {
  if (bits < 1 || bits > 24 || la < 1 || lb < 1 || la * bits > 32 ||
      lb * bits > 32)
    return false;
  dp->offset_a = static_cast<uint32_t>(offset_a);
  dp->offset_b = static_cast<uint32_t>(offset_b);
  dp->mask = (1u << bits) - 1u;
  dp->half = 1u << (bits - 1);
  dp->bits = bits;
  dp->la = la;
  dp->lb = lb;
  dp->limbs = (bits + 7) / 8;
  dp->bias = 0u;
  for (int k = 0; k + 1 < dp->limbs; ++k) dp->bias += 128u << (8 * k);
  return true;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
// The caller guarantees: device pointers of the stated shapes, contiguous,
// 16-byte aligned; v int8 [n_primes, rows, 2N]; N % 64 == 0; 1 <= n_primes
// <= 8; 0 <= drop < 32.  The column tile is 64 wide when that gives every
// SM a block, else 32.
extern "C" int ztfhe_ntt_inverse_crt_acc(
    const int8_t* v, const int* acc, int* out, const int8_t* m_lo,
    const int8_t* m_hi, const int* primes, const int* crt_e,
    const float* inv_p, const float* theta, int p_mod, int n_primes,
    int rows, int N, int drop, void* stream) {
  return entry<Digits::kNone>(v, acc, out, m_lo, m_hi, primes, crt_e, inv_p,
                              theta, p_mod, n_primes, rows, N, drop, nullptr,
                              DigitParams{}, stream);
}

// The same, and the next step's gadget digits of `out` into `digits` (see
// the header): at 1 <= bits <= 8 the rows, int8 [rows / 2, la + lb, N]; at
// 9 <= bits <= 24 their n_dl = ceil(bits / 8) limb planes, int8 [rows / 2,
// (la + lb) n_dl, N].  Offsets mod 2^32 of the a and b components, 1 <=
// la, lb and la * bits, lb * bits <= 32, rows even.
extern "C" int ztfhe_ntt_inverse_crt_acc_digits(
    const int8_t* v, const int* acc, int* out, const int8_t* m_lo,
    const int8_t* m_hi, const int* primes, const int* crt_e,
    const float* inv_p, const float* theta, int p_mod, int n_primes,
    int rows, int N, int drop, int8_t* digits, int offset_a, int offset_b,
    int bits, int la, int lb, void* stream) {
  DigitParams dp;
  if (!digit_params(&dp, offset_a, offset_b, bits, la, lb) || rows % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bits <= 8)
    return entry<Digits::kRows>(v, acc, out, m_lo, m_hi, primes, crt_e, inv_p,
                                theta, p_mod, n_primes, rows, N, drop, digits,
                                dp, stream);
  return entry<Digits::kLimbRows>(v, acc, out, m_lo, m_hi, primes, crt_e,
                                  inv_p, theta, p_mod, n_primes, rows, N, drop,
                                  digits, dp, stream);
}

// The same on the split ring's views (rows = 4B: (b, c, q)), and the next
// step's half-rows of `out` into `digits`, int8 [rows / 4, 2 (la + lb), N]
// (see the header): the hi words of the a and b components' offsets,
// 1 <= bits <= 8, the other conditions as above, rows a multiple of 4.
extern "C" int ztfhe_ntt_inverse_crt_acc_half_rows(
    const int8_t* v, const int* acc, int* out, const int8_t* m_lo,
    const int8_t* m_hi, const int* primes, const int* crt_e,
    const float* inv_p, const float* theta, int p_mod, int n_primes,
    int rows, int N, int drop, int8_t* digits, int offset_a, int offset_b,
    int bits, int la, int lb, void* stream) {
  DigitParams dp;
  if (!digit_params(&dp, offset_a, offset_b, bits, la, lb) || bits > 8 ||
      rows % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return entry<Digits::kHalfRows>(v, acc, out, m_lo, m_hi, primes, crt_e,
                                  inv_p, theta, p_mod, n_primes, rows, N, drop,
                                  digits, dp, stream);
}

extern "C" const char* ztfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
