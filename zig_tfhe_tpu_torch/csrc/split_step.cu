// K2s: the split-ring blind-rotation step core, hand-written for Hopper
// (sm_90a).
//
// The function of the TPU kernel zig_tfhe_tpu/ops/pallas/ntt_step.py:
// ntt_step_fused_pallas (digits -> forward NTT as int8 matmuls -> pointwise
// products with the step's key residues -> multi-bit rotation combine ->
// residues for the inverse NTT) at the shape of the even/odd split-ring
// step of the 64-bit torus (ops/split_ring.py; the JAX package runs this
// step in XLA, zig_tfhe_tpu/ops/split_ring.py:424-480, and has no Pallas
// kernel for it).  Against K2 (csrc/ntt_step.cu) four things differ: each
// batch element has 2R half-rows (row r' = 2r + q_in of the hi-plane
// decomposition) instead of R rows; the key step folds the Y-twist into 4
// output planes (c' = 2c + q_out) instead of 2; the plan has 4 primes on
// N/2 = 1024; and the multi-bit combine is the Y-twisted pair product of
// ops/split_ring.py:rotate_combine_multi_split.  Group 2, one-limb digits
// (Bg_e <= 2^8).  For each CRT prime p and each (b, k), k a column of the
// N/2 transform:
//
//   d_hat[r] = barrett(barrett(d_r @ fwd_lo) + 256 barrett(d_r @ fwd_hi))
//   u_m[c']  = barrett(sum over row groups of barrett(sum_r d_hat[r] K_m[r, c']))
//   (x_1, y_1), (x_2, y_2): X^t - 1 as split pairs, t_j = 2 u_j + odd_j:
//              odd ? (-1, row(u)) : (row(u) - 1, 0), row(u) = psi^(u(2k+1))
//   x_3 = barrett(x_2 x_1 + psi1 barrett(y_2 y_1)),
//   y_3 = barrett(x_2 y_1 + y_2 x_1)                        (psi1 = row(1))
//   v[c][0] = barrett(sum_m barrett(x_m u_m[2c] + psi1 barrett(y_m u_m[2c+1])))
//   v[c][1] = barrett(sum_m barrett(x_m u_m[2c+1] + y_m u_m[2c]))
//
// with every reduction where the plain chain places it (_forward's reduce-
// then-combine, _pointwise's row groups of the plan's smallest row_group with
// a Barrett per group and one on the group sum, rotate_combine_multi_split's
// DP and its apply with one inner Barrett on each y-side product), so v is
// bit-equal to split_step_fused_reference.  The residues leave as K1's
// int8 limb planes [P, B, 2(c), 2(q), 2(limb), N/2] (v == lo + 256 hi), which
// K1 (csrc/ntt_inverse.cu) takes as [P, 2B, 2, 2, N/2] rows (b, c): the
// step is the hi-plane decompose, this kernel, then K1.
//
// Bound on this card at the path's shapes (SECURITY_128_BIT_T64: B = 2048,
// 2R = 10, N/2 = 1024, P = 4):
//   tensor cores: B * 2R * N/2 * N/2 * 2 matrix limbs * P = 171.8 G int8
//     MACs, 343.6 G operations: 173.6 us at 1,979 TOPS;
//   CUDA cores: per (b, k, prime) 127 Barretts (30 forward combine, 72
//     pointwise, 3 subset DP, 18 apply, 4 final) and 165 int32 multiplies
//     (120 pointwise, 10 combine, 5 DP, 30 apply).  A Barrett's least work
//     is an int32 -> f32 (I2FP, on the ALU pipe), an f32 multiply, the
//     rounding and an int32 multiply-subtract (IMAD, on the FMA pipe); the
//     rounding is an f32 -> int32 conversion (16 a clock per SM, measured)
//     or the f32 add below (FMA) and an int32 add (ALU).  The split between
//     the two that balances the pipes best
//     (chip_smoke.py:_cuda_core_clocks, held to the card's measured
//     Barrett rates by phase 2 of chip_smoke.py) gives 5.56 SM-clocks per
//     (b, k, prime), the issue rate (128 a clock) and the conversion pipe
//     both full: 4 x 2.1 M (b, k) / 132 SMs / 1.98 GHz = 178.3 us;
//   memory: digits 21 MB, key step 1 MB, matrices 8.4 MB, the psi rows
//     gathered (at most the whole table, 16.8 MB), limb planes out 67 MB:
//     about 34 us at 3.35 TB/s.
// So the CUDA cores bound it, the tensor cores just behind
// (chip_smoke.py:_k2s_bound_ms computes both from the run's shapes).
// L2 -> SM traffic of this tiling: every (prime, column tile) reads the
// digits (4 x 8 x 21 MB = 0.7 GB) and every row tile of 6 lanes all four
// primes' matrices (342 x 8.4 MB = 2.9 GB): 3.6 GB a call, about 2.7x K2's
// at g2; the tile is one wgmma tall, as K2's.
//
// Design: K2's, the one-limb group-2 case, with a split-shaped epilogue.
// Persistent blocks, one per SM, each walk a contiguous range of the tiles
// (prime, column tile, row tile; row tiles fastest), so that a block
// stages a column tile's key residues once for its run of row tiles.  A
// tile is 64 wgmma rows (TB = 64 / 2R lanes with all their half-rows: 6 at
// 2R = 10, rows 60-63 computed and unused) x BN columns (BN = 128; 32 when
// 128 would leave SMs without a tile).  Four warpgroups:
//   * a producer warp: one thread fills a ring of stages with TMA (BK = 128
//     contraction bytes of the digit tile and of both matrix tiles,
//     128-byte swizzle), `full` mbarriers carrying the byte count;
//   * one product warpgroup: per stage 8 wgmma.m64nBNk32.s8.s8 (4
//     contraction steps x 2 matrix limbs), the stage released when its
//     group has retired; after the last stage the reduce-then-combine
//     Barretts of every sum, stored as int16 d_hat (|d_hat| <= 0.52 p <
//     2^15) into one of two shared buffers (`d_full` / `d_empty`);
//   * two pointwise warpgroups, thread = column k and 3 lanes of the tile
//     (lanes 0-2 or 3-5 at 2R = 10), 160 registers each (the producer's
//     give-back beyond the product warpgroup's 168): they stage the key
//     tile (3 subsets x 2R rows x BN columns x 4 planes, int32, so that one
//     16-byte load gives the 4 planes of (m, r, k) and serves all 3 lanes),
//     fetch their lanes' rotations and rot rows of u_j = t_j >> 1 before
//     waiting for d_hat, build the subset pairs, and run one subset at a
//     time (the 4 pointwise sums of 3 lanes, then their share of the
//     apply), then write the 8 int8 limb bytes of each (b, k).
//   The pointwise loops over half-rows and row groups are unrolled at 2R =
//   10 and 8 with row group 2 (SECURITY_128_BIT_T64, TEST_TINY_SPLIT);
//   other shapes, and every narrow tile, run one instance that reads 2R and
//   the row group at run time.
// The int16 d_hat buffers and the 60 KB key tile leave room for 3 ring
// stages at BN = 128.
// Measured on an H100 (tools/torch_kernel_probe.py --split): the earlier
// version of this kernel, thread = column and one lane, 3 pointwise
// warpgroups of 96 registers and a runtime row loop, spent 849 of its 922
// us in the pointwise stage alone, and replacing its Barretts by shifts
// saved only 110 us: it was latency-bound, not held by the conversion
// pipe.
//
// Exactness.  Barrett is round(f32(x) * f32(1/p)) half to even
// (__float2int_rn(__fmul_rn(__int2float_rn(x), inv_p))), like torch.round,
// computed with the rounding as an f32 add (barrett() below; barrett_cvt is
// the plain form, and the check kernels hold the two equal on every int32);
// every wrapping sum and product is uint32 (signed overflow is undefined in
// C++), as int32 tensors wrap; the build passes -fmad=false.  Every Barrett
// sees the same int32 as in the plain version, so the two are compared
// for equality.


#include "hopper_prims.cuh"

namespace {

using namespace hopper;

constexpr int kMaxPrimes = 8;
constexpr int kMaxRows = 10;    // half-rows 2R of a batch element
constexpr int kSubsets = 3;     // 2^2 - 1 at group 2
constexpr int kPlanes = 4;      // (component, output parity)
constexpr int kMinPrime = 2048; // barrett()'s rounding is exact for p >= 2^11
constexpr int BM = 64;          // wgmma rows per tile: TB = BM / 2R
constexpr int BK = 128;         // contraction bytes per stage
constexpr int kLanes = 3;       // lanes of a pointwise thread
constexpr int kPointwiseGroups = 2;
constexpr int kPointwiseThreads = 128 * kPointwiseGroups;
constexpr int kThreads = 128 * (kPointwiseGroups + 2);
// registers a thread: the launch gives every thread kBaseRegs; the producer
// keeps 24, the product warpgroup takes 168 (its 128 sums and the
// epilogue) of what that frees, the pointwise warpgroups share the rest
constexpr int kBaseRegs = 65536 / kThreads / 8 * 8;
constexpr int kProductRegs = 168;
constexpr int kPointwiseRegs =
    kBaseRegs + ((kBaseRegs - 24) - (kProductRegs - kBaseRegs)) * 128 /
                    kPointwiseThreads / 8 * 8;
static_assert(kPointwiseRegs > kBaseRegs, "registers");
constexpr int kBuffers = 2;     // d_hat buffers between product and pointwise
constexpr int kMaxStages = 8;
constexpr int kSmemCap = 232448;   // bytes a block can use on this card
// full[kMaxStages], empty[kMaxStages], d_full[kBuffers], d_empty[kBuffers]
constexpr int kBarrierBytes = (2 * kMaxStages + 2 * kBuffers) * 8;

// Stage switches for tools/torch_kernel_probe.py --split only (the results
// are then wrong): -DZTFHE_PROBE_NO_PRODUCT drops the TMA loads and the
// wgmmas, -DZTFHE_PROBE_NO_POINTWISE the per-(b, k) stage after d_hat,
// -DZTFHE_PROBE_BARRETT_IMAD replaces each Barrett's conversions and
// multiply by a shift that keeps the value live.
#ifdef ZTFHE_PROBE_NO_PRODUCT
constexpr bool kProduct = false;
#else
constexpr bool kProduct = true;
#endif
#ifdef ZTFHE_PROBE_NO_POINTWISE
constexpr bool kPointwise = false;
#else
constexpr bool kPointwise = true;
#endif

struct StepParams {
  int p[kMaxPrimes];
  float inv_p[kMaxPrimes];
};

__device__ __forceinline__ uint32_t u32(int x) { return static_cast<uint32_t>(x); }

// The Barrett of the plain version, round(f32(x) * f32(1/p)) half to even
// as torch.round, r = x - q*p wrapping: f32 -> int32 runs on the
// conversion pipe (16 a clock per SM on this card).  The check kernels
// below hold barrett() to it.
__device__ __forceinline__ int barrett_cvt(uint32_t x, int p, float inv_p) {
  const int q = __float2int_rn(__fmul_rn(__int2float_rn(static_cast<int>(x)), inv_p));
  return static_cast<int>(x - u32(q) * u32(p));
}

// The same function with the rounding off the conversion pipe: adding
// 1.5 * 2^23 rounds f = f32(x) * f32(1/p) to an integer, half to even, in
// the mantissa of r, exactly while |f| < 2^22; |x| <= 2^31 and p >= 2^11
// (the entry point refuses smaller primes) keep |f| <= 2^20.  The int32 ->
// f32 side stays: ptxas issues it as I2FP, an ALU instruction.
__device__ __forceinline__ int barrett(uint32_t x, int p, float inv_p) {
#ifdef ZTFHE_PROBE_BARRETT_IMAD
  const uint32_t q = x >> 16;
#else
  const float r = __fadd_rn(__fmul_rn(__int2float_rn(static_cast<int>(x)), inv_p),
                            12582912.0f);
  const uint32_t q = u32(__float_as_int(r) - 0x4B400000);
#endif
  return static_cast<int>(x - q * u32(p));
}

// The 4 pointwise sums of kLanes lanes (b, k), (b + 1, k), ... for one
// subset: u[l][c'] = sum_r d[l][r] * key[r, c'], a Barrett after every row
// group, the group partials summed and reduced once more
// (ops/split_ring.py:_pointwise).  key[r, c'] is k_col[r * BN * 4 + c'],
// one 16-byte load for all the lanes.  RLC, RGC: the half-rows and the row
// group at compile time, or 0 for the runtime rl, rg.
template <int BN, int RLC, int RGC>
__device__ __forceinline__ void pointwise_lanes(const int (&d)[kLanes][kMaxRows],
                                                const int* k_col, int rl,
                                                int rg, int p, float inv_p,
                                                int (&u)[kLanes][kPlanes]) {
  constexpr int RMAX = RLC ? RLC : kMaxRows;
  uint32_t part[kLanes][kPlanes], acc[kLanes][kPlanes];
#pragma unroll
  for (int l = 0; l < kLanes; ++l)
#pragma unroll
    for (int c = 0; c < kPlanes; ++c) {
      part[l][c] = 0u;
      acc[l][c] = 0u;
    }
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (!RLC && r >= rl) break;
    const int4 kv = *reinterpret_cast<const int4*>(k_col + r * BN * kPlanes);
    const uint32_t kc[kPlanes] = {u32(kv.x), u32(kv.y), u32(kv.z), u32(kv.w)};
#pragma unroll
    for (int l = 0; l < kLanes; ++l)
#pragma unroll
      for (int c = 0; c < kPlanes; ++c) part[l][c] += u32(d[l][r]) * kc[c];
    const bool close = RLC ? ((r + 1) % RGC == 0 || r == RLC - 1)
                           : (++cnt == rg || r == rl - 1);
    if (close) {
      if (!RLC) cnt = 0;
#pragma unroll
      for (int l = 0; l < kLanes; ++l)
#pragma unroll
        for (int c = 0; c < kPlanes; ++c) {
          acc[l][c] += u32(barrett(part[l][c], p, inv_p));
          part[l][c] = 0u;
        }
    }
  }
#pragma unroll
  for (int l = 0; l < kLanes; ++l)
#pragma unroll
    for (int c = 0; c < kPlanes; ++c) u[l][c] = barrett(acc[l][c], p, inv_p);
}

// shared memory of one block: the ring, then two buffers of d_hat [BM][BN +
// 8] int16, then the key tile [3][2R][BN][4] int32 (the 4 planes of (m, r,
// k) in 16 bytes), then the barriers
__host__ __device__ constexpr int stage_bytes(int bn) {
  return BM * BK + 2 * bn * BK;
}
__host__ __device__ constexpr int dhat_bytes(int bn) {
  return BM * (bn + 8) * 2;
}
__host__ __device__ constexpr int key_tile_bytes(int RL, int bn) {
  return kSubsets * RL * kPlanes * bn * 4;
}
__host__ __device__ constexpr int buffer_bytes(int RL, int bn) {
  return kBuffers * dhat_bytes(bn) + key_tile_bytes(RL, bn);
}
// stages that fit beside the buffers (at most kMaxStages)
__host__ __device__ constexpr int stages_that_fit(int RL, int bn) {
  const int left = kSmemCap - 1024 - buffer_bytes(RL, bn) - kBarrierBytes;
  const int n = left / stage_bytes(bn);
  return n > kMaxStages ? kMaxStages : n;
}

// map_d:  int8 [B * 2R, N]          the digits' half-rows, box [BK, 64]
// map_lo, map_hi: int8 [P * N, N]   forward matrix limbs, transposed (k, j) so
//                                   the contraction axis is contiguous, box [BK, BN]
// bsk:    int16 [3, P, 2R, 4, N]    one step of the folded split key
// ts:     int32 [2, B]              rotation amounts in [0, 4N)
// rot:    int16 [P, 2N, N]          centred psi^{u(2k+1)} (row 1 is psi1)
// v:      int8 [P, B, 2, 2, 2, N]   limb planes (lo, hi) of the residues
// (N is the transform size, half the ring degree.)  RLC, RGC: 2R and the
// row group at compile time (0: the runtime RL and rg, RL <= kMaxRows).
template <int BN, int RLC, int RGC>
__global__ void __launch_bounds__(kThreads, 1)
split_step_kernel(const __grid_constant__ CUtensorMap map_d,
                  const __grid_constant__ CUtensorMap map_lo,
                  const __grid_constant__ CUtensorMap map_hi,
                  const int16_t* __restrict__ bsk, const int* __restrict__ ts,
                  const int16_t* __restrict__ rot, int8_t* __restrict__ v,
                  StepParams sp, int n_primes, int rg_arg, int B, int RL_arg,
                  int N, int n_stages) {
  constexpr int REGS = BN / 2;     // sums per thread of a 64 x BN tile
  constexpr int LDD = BN + 8;      // d_hat row stride (int16): the 32-bit
                                   // stores of a warp hit 32 distinct banks
  const int RL = RLC ? RLC : RL_arg;
  const int rg = RGC ? RGC : rg_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tiles = align_1024(smem);
  unsigned char* bufs = tiles + n_stages * stage_bytes(BN);
  int* k_s = reinterpret_cast<int*>(bufs + kBuffers * dhat_bytes(BN));
  uint64_t* full = reinterpret_cast<uint64_t*>(bufs + buffer_bytes(RL, BN));
  uint64_t* empty = full + kMaxStages;
  uint64_t* d_full = empty + kMaxStages;    // d_hat of a buffer is written
  uint64_t* d_empty = d_full + kBuffers;    // ... and has been read

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tb = BM / RL;                 // batch elements per tile
  const int nrt = (B + tb - 1) / tb;      // row tiles
  const int nct = N / BN;                 // column tiles
  const int n_tiles = n_primes * nct * nrt;
  const int nk = N / BK;
  // each block walks a contiguous range of tiles: the key tile of a
  // (prime, column tile) is staged once for its run of row tiles
  const int t_first = static_cast<int>(static_cast<long long>(blockIdx.x) *
                                       n_tiles / gridDim.x);
  const int t_last = static_cast<int>(static_cast<long long>(blockIdx.x + 1) *
                                      n_tiles / gridDim.x);

  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);
    }
    for (int c = 0; c < kBuffers; ++c) {
      mbar_init(d_full + c, 128);
      mbar_init(d_empty + c, kPointwiseThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kPointwiseGroups + 1) {
    // -- producer: one thread fills the ring, tile after tile ---------------
    reg_dec<24>();
    if (tid == (kPointwiseGroups + 1) * 128) {
      int s = 0;
      uint32_t ph = 1;   // the ring starts empty: the first waits pass
      for (int id = t_first; kProduct && id < t_last; ++id) {
        const int rt = id % nrt, ct = (id / nrt) % nct, pi = id / (nrt * nct);
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(empty + s, ph);
          unsigned char* st = tiles + s * stage_bytes(BN);
          mbar_arrive_expect_tx(full + s, stage_bytes(BN));
          tma_load_2d(st, &map_d, kc * BK, rt * tb * RL, full + s);
          tma_load_2d(st + BM * BK, &map_lo, kc * BK, pi * N + ct * BN, full + s);
          tma_load_2d(st + BM * BK + BN * BK, &map_hi, kc * BK,
                      pi * N + ct * BN, full + s);
          if (++s == n_stages) {
            s = 0;
            ph ^= 1u;
          }
        }
      }
    }
  } else if (wg == kPointwiseGroups) {
    // -- product warpgroup: forward NTT of every tile -> d_hat --------------
    reg_inc<kProductRegs>();
    const int wt = tid & 127;
    const int lane = wt & 31, warp = wt >> 5;
    const int g = lane >> 2, t = lane & 3;
    const bool elected = wt == 0;
    int s = 0;
    uint32_t ph = 0;
    int j = 0;   // index of the tile in the block's order
    for (int id = t_first; id < t_last; ++id, ++j) {
      const int pi = id / (nrt * nct);
      const int p = sp.p[pi];
      const float inv_p = sp.inv_p[pi];

      // [64, N] @ [N, BN], lo and hi matrix limbs
      int zlo[REGS], zhi[REGS];
#pragma unroll
      for (int i = 0; i < REGS; ++i) {
        zlo[i] = 0;
        zhi[i] = 0;
      }
      int pending = -1;   // the stage whose wgmma group is still in flight
      for (int kc = 0; kProduct && kc < nk; ++kc) {
        mbar_wait(full + s, ph);
        const unsigned char* st = tiles + s * stage_bytes(BN);
        const uint64_t da = make_desc<BK>(st);
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
        if (++s == n_stages) {
          s = 0;
          ph ^= 1u;
        }
      }
      wgmma_wait<0>();
      fence_acc(zlo);
      fence_acc(zhi);
      if (kProduct && elected) mbar_arrive(empty + pending);

      // reduce-then-combine + Barrett -> int16 d_hat, in the buffer the
      // pointwise warpgroups have finished with (its first use is free)
      const int buf = j % kBuffers;
      int16_t* d_s = reinterpret_cast<int16_t*>(bufs + buf * dhat_bytes(BN));
      mbar_wait(d_empty + buf, ((j / kBuffers) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < REGS; i += 2) {
        uint32_t y[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int lo = zlo[i + jj], hi = zhi[i + jj];
          y[jj] = u32(barrett(u32(barrett(u32(lo), p, inv_p)) +
                                  u32(barrett(u32(hi), p, inv_p)) * 256u,
                              p, inv_p));
        }
        const int r = warp * 16 + g + 8 * ((i / 2) % 2);
        const int c = 8 * (i / 4) + t * 2;
        *reinterpret_cast<uint32_t*>(d_s + r * LDD + c) =
            (y[0] & 0xFFFFu) | (y[1] << 16);
      }
      mbar_arrive(d_full + buf);   // all 128 threads: their stores are out
    }
  } else {
    // -- pointwise warpgroups: products with the key + split combine --------
    // Thread = column k and kLanes lanes of the tile: every key load serves
    // them all.
    reg_inc<kPointwiseRegs>();
    const int pt = tid;                     // 0 .. kPointwiseThreads - 1
    const int k = pt % BN;
    constexpr int BSTEP = kPointwiseThreads / BN;   // lane groups a column
    int key_id = -1;   // the (prime, column tile) of the key tile
    int j = 0;
    for (int id = t_first; id < t_last; ++id, ++j) {
      const int rt = id % nrt, ct = (id / nrt) % nct, pi = id / (nrt * nct);
      const int b0 = rt * tb;
      const int nb = min(tb, B - b0);        // live batch elements of the tile
      const int col0 = ct * BN;
      const int p = sp.p[pi];
      const float inv_p = sp.inv_p[pi];
      const int buf = j % kBuffers;
      const int16_t* d_s =
          reinterpret_cast<const int16_t*>(bufs + buf * dhat_bytes(BN));
      const int16_t* rot_k =
          rot + static_cast<size_t>(pi) * 2 * N * N + col0 + k;
      // t_j mod 4N and the rot row of u_j = t_j >> 1 of the thread's lanes
      // b = kLanes q + l of group q (lanes past the tile read lane 0's)
      auto fetch = [&](int q, int (&tt)[kLanes][2], int (&raw)[kLanes][2]) {
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          const int b = kLanes * q + l < nb ? kLanes * q + l : 0;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            tt[l][jj] = ts[jj * B + b0 + b] & (4 * N - 1);
            raw[l][jj] = rot_k[static_cast<size_t>(tt[l][jj] >> 1) * N];
          }
        }
      };
      // the first group's rotations are in flight while the key tile is
      // staged and the product warpgroup finishes d_hat
      int tt0[kLanes][2], raw0[kLanes][2];
      if (kLanes * (pt / BN) < nb) fetch(pt / BN, tt0, raw0);

      // the column tile's key residues when they change (once per run of
      // row tiles): k_s[((m * 2R + r) * BN + k) * 4 + c'], each 8 columns
      // of the 4 planes of (m, r) read as four 16-byte loads and stored as
      // eight 16-byte (k, 4 planes) rows, after every thread has finished
      // with the last tile's
      const int kid = pi * nct + ct;
      if (key_id != kid) {
        if (key_id >= 0) named_barrier_sync(1, kPointwiseThreads);
        key_id = kid;
        const int units = kSubsets * RL * (BN / 8);
        for (int idx = pt; idx < units; idx += kPointwiseThreads) {
          const int mr = idx / (BN / 8), c8 = idx % (BN / 8);
          const int m = mr / RL, r = mr % RL;
          const int16_t* src =
              bsk + (static_cast<size_t>(m * n_primes + pi) * RL + r) * kPlanes * N +
              col0 + c8 * 8;
          int4 w[kPlanes];
#pragma unroll
          for (int c = 0; c < kPlanes; ++c)
            w[c] = *reinterpret_cast<const int4*>(src + c * N);
          const int16_t* h[kPlanes];
#pragma unroll
          for (int c = 0; c < kPlanes; ++c)
            h[c] = reinterpret_cast<const int16_t*>(&w[c]);
          int4* dst = reinterpret_cast<int4*>(k_s + (mr * BN + c8 * 8) * kPlanes);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = make_int4(h[0][e], h[1][e], h[2][e], h[3][e]);
        }
      }
      named_barrier_sync(1, kPointwiseThreads);   // key tile written
      mbar_wait(d_full + buf, (j / kBuffers) & 1);

      const int psi1 = rot_k[N];
      const int* k_col = k_s + k * kPlanes;
      for (int q = pt / BN; kPointwise && kLanes * q < nb; q += BSTEP) {
        int tt[kLanes][2], raw[kLanes][2];
        if (q == pt / BN) {
#pragma unroll
          for (int l = 0; l < kLanes; ++l)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              tt[l][jj] = tt0[l][jj];
              raw[l][jj] = raw0[l][jj];
            }
        } else {
          fetch(q, tt, raw);
        }
        // d_hat of the lanes (one past nb reads lane kLanes q's again)
        int d[kLanes][kMaxRows];
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          const int b = kLanes * q + l < nb ? kLanes * q + l : kLanes * q;
          const int16_t* dl = d_s + b * RL * LDD + k;
#pragma unroll
          for (int r = 0; r < (RLC ? RLC : kMaxRows); ++r)
            d[l][r] = (RLC || r < RL) ? dl[r * LDD] : 0;
        }
        // X^{t_j} - 1 as split pairs (x, y), then the pair of subset {1, 2}
        int x[kLanes][kSubsets], y[kLanes][kSubsets];
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const bool odd = (tt[l][jj] & 1) != 0;
            x[l][jj] = odd ? -1 : raw[l][jj] - 1;
            y[l][jj] = odd ? raw[l][jj] : 0;
          }
          const int w = barrett(u32(y[l][1]) * u32(y[l][0]), p, inv_p);
          x[l][2] = barrett(u32(x[l][1]) * u32(x[l][0]) + u32(psi1) * u32(w), p,
                            inv_p);
          y[l][2] = barrett(u32(x[l][1]) * u32(y[l][0]) + u32(y[l][1]) * u32(x[l][0]),
                            p, inv_p);
        }
        uint32_t ve[kLanes][2], vo[kLanes][2];
#pragma unroll
        for (int l = 0; l < kLanes; ++l)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            ve[l][c] = 0u;
            vo[l][c] = 0u;
          }
        // one subset at a time: its sums and its share of the apply
#pragma unroll 1
        for (int m = 0; m < kSubsets; ++m) {
          int u[kLanes][kPlanes];
          pointwise_lanes<BN, RLC, RGC>(d, k_col + m * RL * BN * kPlanes, RL, rg,
                                        p, inv_p, u);
#pragma unroll
          for (int l = 0; l < kLanes; ++l) {
            const int xm = m == 0 ? x[l][0] : m == 1 ? x[l][1] : x[l][2];
            const int ym = m == 0 ? y[l][0] : m == 1 ? y[l][1] : y[l][2];
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int ue = u[l][2 * c], uo = u[l][2 * c + 1];
              const int we = barrett(u32(ym) * u32(uo), p, inv_p);
              ve[l][c] += u32(barrett(u32(xm) * u32(ue) + u32(psi1) * u32(we),
                                      p, inv_p));
              vo[l][c] += u32(barrett(u32(xm) * u32(uo) + u32(ym) * u32(ue),
                                      p, inv_p));
            }
          }
        }
        // v == lo + 256 hi with lo in [-128, 128): K1's int8 limb planes
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          if (kLanes * q + l >= nb) break;
          const int gb = b0 + kLanes * q + l;
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
              // lo is out's low byte read as int8, hi = (out - lo) / 256
              const int out = barrett(qq ? vo[l][c] : ve[l][c], p, inv_p);
              int8_t* dst =
                  v + (((static_cast<size_t>(pi) * B + gb) * 2 + c) * 2 + qq) * 2 * N +
                  col0 + k;
              dst[0] = static_cast<int8_t>(out);
              dst[N] = static_cast<int8_t>((out + 128) >> 8);
            }
        }
      }
      mbar_arrive(d_empty + buf);   // all threads: the buffer's d_hat is read
    }
  }
}

// r[i] = barrett(x[i]) for i < n: the kernel's Barrett on chosen inputs
__global__ void barrett_kernel(const int* __restrict__ x, int* __restrict__ r,
                               int n, int p, float inv_p) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    r[i] = barrett(u32(x[i]), p, inv_p);
}

// the inputs x = start + i (mod 2^32), 0 <= i < count, on which barrett and
// barrett_cvt differ, counted into *n_diff
__global__ void barrett_check_kernel(uint32_t start, unsigned long long count,
                                     int p, float inv_p,
                                     unsigned long long* n_diff) {
  unsigned long long c = 0;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    const uint32_t x = start + static_cast<uint32_t>(i);
    c += barrett(x, p, inv_p) != barrett_cvt(x, p, inv_p);
  }
  if (c) atomicAdd(n_diff, c);
}

// the matrix planes are constant per plan: their descriptors are encoded
// once per (pointer, shape, tile) and kept (per host thread)
struct MatrixMaps {
  const void* lo = nullptr;
  const void* hi = nullptr;
  int n = 0, primes = 0;
  CUtensorMap map_lo, map_hi;
};

template <int BN, int RLC, int RGC>
int launch(const int8_t* digits, const int16_t* bsk, const int* ts,
           const int8_t* f_lo, const int8_t* f_hi, const int16_t* rot,
           int8_t* v, const StepParams& sp, int n_primes, int rg, int B,
           int RL, int N, cudaStream_t stream) {
  thread_local MatrixMaps cache;
  MatrixMaps& m = cache;
  const uint64_t n64 = static_cast<uint64_t>(N);
  if (m.lo != f_lo || m.hi != f_hi || m.n != N || m.primes != n_primes) {
    const uint64_t dims[2] = {n64, static_cast<uint64_t>(n_primes) * N};
    const uint64_t strides[1] = {n64};
    const uint32_t box[2] = {BK, BN};
    int e = make_tensor_map(&m.map_lo, f_lo, 2, dims, strides, box);
    if (!e) e = make_tensor_map(&m.map_hi, f_hi, 2, dims, strides, box);
    if (e) return e;
    m.lo = f_lo;
    m.hi = f_hi;
    m.n = N;
    m.primes = n_primes;
  }
  CUtensorMap map_d;
  {
    const uint64_t dims[2] = {n64, static_cast<uint64_t>(B) * RL};
    const uint64_t strides[1] = {n64};
    const uint32_t box[2] = {BK, BM};
    const int e = make_tensor_map(&map_d, digits, 2, dims, strides, box);
    if (e) return e;
  }
  const int n_stages = stages_that_fit(RL, BN);
  const int bytes = 1024 + n_stages * stage_bytes(BN) + buffer_bytes(RL, BN) +
                    kBarrierBytes;
  // above 48 KB, dynamic shared memory needs the cap raised (set once per
  // device and size: the call costs host time on a host-bound path)
  thread_local int cap_device = -1, cap_bytes = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device != cap_device || bytes != cap_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_step_kernel<BN, RLC, RGC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap_device = device;
    cap_bytes = bytes;
  }
  const int tb = BM / RL;
  const int n_tiles = n_primes * (N / BN) * ((B + tb - 1) / tb);
  const dim3 grid(n_tiles < sm_count() ? n_tiles : sm_count());
  split_step_kernel<BN, RLC, RGC><<<grid, kThreads, bytes, stream>>>(
      map_d, m.map_lo, m.map_hi, bsk, ts, rot, v, sp, n_primes, rg, B, RL, N,
      n_stages);
  return static_cast<int>(cudaGetLastError());
}

// 2R = 10 and 8 at row group 2 (SECURITY_128_BIT_T64's and TEST_TINY_SPLIT's
// shapes) are compiled for; any other 2R and row group, and the narrow
// tile, run the instance that reads them at run time
template <int BN>
int dispatch(const int8_t* digits, const int16_t* bsk, const int* ts,
             const int8_t* f_lo, const int8_t* f_hi, const int16_t* rot,
             int8_t* v, const StepParams& sp, int n_primes, int rg, int B,
             int RL, int N, cudaStream_t s) {
  if constexpr (BN == 128) {
    if (RL == 10 && rg == 2)
      return launch<BN, 10, 2>(digits, bsk, ts, f_lo, f_hi, rot, v, sp,
                               n_primes, rg, B, RL, N, s);
    if (RL == 8 && rg == 2)
      return launch<BN, 8, 2>(digits, bsk, ts, f_lo, f_hi, rot, v, sp,
                              n_primes, rg, B, RL, N, s);
  }
  return launch<BN, 0, 0>(digits, bsk, ts, f_lo, f_hi, rot, v, sp, n_primes,
                          rg, B, RL, N, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
// The 64 x 128 tile when that many tiles give every SM one and 3 stages
// fit beside the consumers' buffers, else 64 x 32.  The caller guarantees:
// device pointers of the stated shapes, contiguous, 16-byte aligned; N %
// 128 == 0; 1 <= n_primes <= 8, every prime >= 2^11; 1 <= RL <= 10
// half-rows a batch element; row_group >= 1.
extern "C" int ztfhe_split_step_fused(
    const int8_t* digits, const int16_t* bsk, const int* ts,
    const int8_t* f_lo, const int8_t* f_hi, const int16_t* rot, int8_t* v,
    const int* primes, const float* inv_p, int n_primes, int row_group, int B,
    int RL, int N, void* stream) {
  if (n_primes < 1 || n_primes > kMaxPrimes || row_group < 1 || B < 1 ||
      RL < 1 || RL > kMaxRows || N < 128 || N % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StepParams sp;
  for (int i = 0; i < kMaxPrimes; ++i) {
    const bool live = i < n_primes;
    if (live && primes[i] < kMinPrime)
      return static_cast<int>(cudaErrorInvalidValue);
    sp.p[i] = live ? primes[i] : kMinPrime;
    sp.inv_p[i] = live ? inv_p[i] : 1.0f / kMinPrime;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tb = BM / RL;
  const int row_tiles = (B + tb - 1) / tb;
  if (n_primes * (N / 128) * row_tiles >= sm_count() &&
      stages_that_fit(RL, 128) >= 3)
    return dispatch<128>(digits, bsk, ts, f_lo, f_hi, rot, v, sp, n_primes,
                         row_group, B, RL, N, s);
  return dispatch<32>(digits, bsk, ts, f_lo, f_hi, rot, v, sp, n_primes,
                      row_group, B, RL, N, s);
}

// r[i] = the kernel's Barrett of x[i] modulo p, i < n (device pointers).
extern "C" int ztfhe_split_barrett(const int* x, int* r, int n, int p,
                                   float inv_p, void* stream) {
  if (n < 0 || p < kMinPrime) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(4 * sm_count());
  barrett_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      x, r, n, p, inv_p);
  return static_cast<int>(cudaGetLastError());
}

// Adds to *n_diff (device) the count of x = start + i (mod 2^32), 0 <= i <
// count, where the kernel's Barrett differs from the plain version's
// (__float2int_rn(__fmul_rn(__int2float_rn(x), inv_p))).
extern "C" int ztfhe_split_barrett_mismatches(int start, long long count,
                                              int p, float inv_p,
                                              unsigned long long* n_diff,
                                              void* stream) {
  if (count < 0 || p < kMinPrime) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(8 * sm_count());
  barrett_check_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t>(start), static_cast<unsigned long long>(count), p,
      inv_p, n_diff);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ztfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
