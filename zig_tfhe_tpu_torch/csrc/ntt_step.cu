// The fused blind-rotation step core, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel zig_tfhe_tpu/ops/pallas/ntt_step.py:
// ntt_step_fused_pallas (Pallas body `_k_fused`, arithmetic
// `_fwd_pointwise_rotate`), and widens it from multi-bit group 2 to group 3,
// the 128-bit key default, and from one-limb engine digits to the uint
// sets' 2- and 3-limb digits (Bg_e up to 2^24) at group 2.  For one step of
// the blind rotation and each CRT prime p it computes, from the int8 limb
// planes of the accumulator's gadget digits (digit r = sum_l 256^l limb
// (r, l), n_dl limbs):
//
//   y_l   = barrett(limb_l @ fwd_lo + 256 * (limb_l @ fwd_hi))  per limb
//   d_hat = Horner over the limbs, top down: barrett(d * 256 + y_l)
//   u_S   = sum over rows r of d_hat[r] * bsk[S, p, r]            per subset S
//   v     = sum over subsets S of prod_{i in S}(psi^{t_i} - 1) * u_S
//
// with the reductions placed exactly where the JAX code of each group
// places them, so v is bit-equal to the JAX package's residues:
//   group 2: the Pallas kernel (one row group for every prime, a final
//            Barrett per pointwise sum, barrett(barrett(d1 u1 + d2 u2) +
//            barrett(d12 u12))); with multi-limb digits the same
//            arithmetic after ops/ntt.py:ntt_forward's limb loop (the JAX
//            package runs those keys on its XLA step2, whose residues
//            differ from these by multiples of p, so K1 gives the same
//            accumulator);
//   group 3: the XLA step_multi fold (pointwise_extprod(reduce_output=
//            False) with per-prime row groups, rotate_combine_multi(u_wide)),
//            one-limb digits only.
// Each limb's combine is the single add lo + (hi << 8) or, where its bound
// fails, barrett(barrett(lo) + 256 barrett(hi)), as _limb_pair_combine
// chooses per prime and limb: a lower limb is bounded by 128, the top limb
// by ops/ntt.py:top_limb_bound (33 at uint4's Bg_e = 2^22, where the top
// limb takes the single add at every prime and the lower limbs only at the
// two primes below 2^15; one-limb digits by Bg_e / 2, which fails the
// single add at 2^8).
//
// What the TPU kernel did next -- the residue limb split, the concatenated
// inverse NTT -- and what its caller did after it -- crt_combine, << drop,
// acc + -- are K1 (csrc/ntt_inverse.cu).  One step is two launches, this
// kernel then K1, with the residues v between them in device memory.  The
// split is forced by the data flow: the pointwise
// product and the combine are local to one NTT column k, but the inverse
// contracts over all N columns, so a block that owns a column tile of the
// forward product cannot finish the inverse.
//
// The residues leave as int8 limb planes [P, B, 2, 2, N] (v == lo + 256 hi,
// every |v| <= 32,639), K1's A operand as it stands: 25 MB per step at
// B = 2048, not 50.
//
// Bound on this card at the path's shapes (B = 2048, N = 1024, P = 3):
//   tensor cores: B * R * N * N * 2 * P int8 MACs = 51.5 G at group 3
//     (R = 4), 64.4 G at group 2 (R = 5): 52.1 us and 65.1 us at 1,979 TOPS;
//   memory: digits 8-10 MB, key step 0.3-0.4 MB, matrices and psi tables
//     18 MB (L2-resident), v 25 MB out: about 15 us at 3.35 TB/s;
//   CUDA cores: per (b, k) over the three primes at group 3 142 Barretts
//     and 222 int32 multiply-adds of the pointwise sums and the subset
//     combine (group 2: 108 and 111).  A Barrett is counted as the least the
//     function needs: int -> f32 (I2FP, on the ALU pipe), an f32 multiply,
//     the rounding and an int32 multiply-subtract (IMAD, on the FMA pipe);
//     the rounding is an f32 -> int conversion (16 a clock per SM,
//     measured, PERF.md) or an f32 add of 1.5 * 2^23 and an int32 add.
//     The stage's time is the larger of all instructions at 128 a clock
//     per SM (the issue rate) and each pipe's (FMA: f32 at 128, IMAD at
//     64; ALU 64; conversion 16), at the split of the roundings between
//     the two forms that balances them best
//     (chip_smoke.py:_cuda_core_clocks, which phase 2 of chip_smoke.py
//     holds to the card's measured Barrett rates): 6.47 SM-clocks x 2.1 M
//     (b, k) / 132 SMs / 1.98 GHz = 51.9 us at group 3 (group 2: 4.52,
//     36.3 us).  This kernel rounds every Barrett on the conversion pipe
//     (__float2int_rn).
// So the tensor cores bound it, with the CUDA-core stage close behind at
// group 3 (chip_smoke.py computes the same counts per path and prints them
// beside the bound).  At uint4's LUT path (group 2, R = 2 rows of 3 limbs,
// 5 primes) the int8 MACs are B * 6 * N * N * 2 * 5 = 128.8 G: 130 us, and
// the CUDA-core stage (per (b, k, prime) 14 forward-combine, 4 Horner, 18
// pointwise and 7 combine Barretts) about 53 us.
//
// L2 -> SM traffic per call at those shapes (group 3; group 2 in brackets).
// A tile reads its 64 digit rows over all N for one prime, and its column
// tile's two matrix planes:
//   first version (128 x 64 tiles): 16 column tiles x 3 primes x 8.4 MB +
//     64 (82) row tiles x 6.3 MB = 0.8 GB (1.0 GB);
//   this version (64 x 128 tiles): 8 x 3 x 8.4 MB + 128 (171) x 6.3 MB +
//     v = 1.03 GB (1.35 GB).
// The tile is wider but only one wgmma tall (its 128 sums a thread are all
// the one product warpgroup can hold); the compulsory traffic is about
// 55 MB.  The traffic did not go down: measured on an NVIDIA H100 80GB HBM3
// at 700 W (tools/torch_kernel_probe.py --split), the product stage alone
// (TMA + wgmma + d_hat) takes 124 us (156 us) and hides behind the
// pointwise stage's 303 us (212 us) in a whole of 348 us (252 us), so the
// bytes are not what the kernel waits for today.  A cluster sharing each matrix tile by TMA
// multicast would halve them when the pointwise stage stops bounding.
//
// Design.  Persistent blocks, one per SM, walk the tiles (prime, column
// tile, row tile; row tiles fastest, so a prime's matrices stay hot in L2).
// A tile is 64 wgmma rows (TB = 64 / (R n_dl) batch elements with all
// their R digit rows of n_dl limb planes each: the limbs ride wgmma's M
// dimension as extra rows, 10 elements a tile at uint4's R n_dl = 6) x BN
// NTT columns (BN = 128; 32 when 128 would leave SMs
// without a tile or N is not a multiple of 128, chosen in the entry point).
// Five warpgroups with three roles, so that the CUDA-core stage of one tile
// runs while the tensor cores work on the next ones:
//   * a producer warp: its one thread fills a ring of stages with TMA, tile
//     after tile: per stage BK = 128 (64 when N is not a multiple of 128)
//     contraction bytes of the digit tile and of both matrix tiles,
//     swizzled; `full` mbarriers carry the byte count;
//   * one product warpgroup: waits for a stage, issues its 8
//     wgmma.m64nBNk32.s8.s8 (4 contraction steps x 2 matrix limbs), commits,
//     releases the stage before it when that group has retired, and after a
//     tile's last stage forms each limb plane's y_l (limb pair combine +
//     Barrett) into one of two shared buffers (`d_full` / `d_empty`
//     mbarriers);
//   * three (group 2) or two (group 3) pointwise warpgroups (thread = NTT
//     column, that many batch elements in flight per column; the count is
//     what the stage's registers allow): they stage the column tile's
//     key residues and the tile's rotation amounts, wait for d_hat, gather
//     the psi rows rot[p][t_j(b) & (2N-1), k] themselves two elements ahead,
//     join each digit row's limb planes by Horner as they read it, and run
//     the pointwise sums and the subset combine in registers, the first
//     version's arithmetic operation for operation.  (The limbs of one row
//     sit in different threads of the product warpgroup's accumulator
//     layout, so the Horner join belongs to the stage that reads d_hat by
//     column.)
// The pointwise stage is what holds the kernel (measured: 1.4 to 2.5 times
// the product stage's time alone), so it gets most of the block's warps;
// the product warpgroup keeps its 128 sums in registers through setmaxnreg
// (168 or 232 registers against 96 or 128 for the others).
//
// Exactness.  Barrett is round(f32(x) * f32(1/p)) half to even
// (__float2int_rn(__fmul_rn(__int2float_rn(x), inv_p))), like jnp.round;
// every wrapping sum and product is uint32 (signed overflow is undefined in
// C++); the build passes -fmad=false.  Since every Barrett sees the same
// int32 as in the plain version, the two are compared for equality.


#include "hopper_prims.cuh"

namespace {

using namespace hopper;

constexpr int kMaxPrimes = 8;
constexpr int kMaxRows = 10;    // limb planes R n_dl of a batch element
constexpr int kMaxLimbs = 3;    // int8 limbs of an engine digit (Bg_e <= 2^24)
constexpr int BM = 64;          // wgmma rows per tile: TB = BM / (R n_dl)
// Warpgroups of a block: pointwise_groups(G) for the pointwise stage first,
// then one product warpgroup (wgmma) and the producer's.  Three pointwise
// warpgroups leave 96 registers a thread, which the group-2 stage fits and
// the group-3 stage does not (measured on an H100 at B = 2048: group 2 245
// us with three against 281 us with two; group 3 387 us with three, with
// spills, against 339 us with two at 128 registers).
__host__ __device__ constexpr int pointwise_groups(int group) {
  return group == 2 ? 3 : 2;
}
__host__ __device__ constexpr int threads(int group) {
  return 128 * (pointwise_groups(group) + 2);
}
// registers a thread: the launch gives every thread base_regs; the producer
// keeps 24 and the product warpgroup takes what that frees
__host__ __device__ constexpr int base_regs(int group) {
  return 65536 / threads(group) / 8 * 8;
}
__host__ __device__ constexpr int product_regs(int group) {
  return 2 * base_regs(group) - 24 > 232 ? 232 : 2 * base_regs(group) - 24;
}
constexpr int kBuffers = 2;     // d_hat buffers between product and pointwise
constexpr int kMaxStages = 8;
constexpr int kSmemCap = 232448;   // bytes a block can use on this card
// full[kMaxStages], empty[kMaxStages], d_full[kBuffers], d_empty[kBuffers]
constexpr int kBarrierBytes = (2 * kMaxStages + 2 * kBuffers) * 8;

// Stage switches for tools/torch_kernel_probe.py --split only (the results
// are then wrong): -DZTFHE_PROBE_NO_PRODUCT drops the TMA loads and the
// wgmmas, -DZTFHE_PROBE_NO_POINTWISE the per-(b, k) stage after d_hat.
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
  int row_group[kMaxPrimes];   // rows summed before a Barrett
  // forward limb combine per prime and limb (pi * kMaxLimbs + l):
  // 1 = lo + (hi << 8)
  int single_add[kMaxPrimes * kMaxLimbs];
};

__device__ __forceinline__ uint32_t u32(int x) { return static_cast<uint32_t>(x); }

// round(f32(x) * f32(1/p)) half to even, as jnp.round; r = x - q*p wraps
__device__ __forceinline__ int barrett(uint32_t x, int p, float inv_p) {
  const int q = __float2int_rn(__fmul_rn(__int2float_rn(static_cast<int>(x)), inv_p));
  return static_cast<int>(x - u32(q) * u32(p));
}

// d_hat of one digit row from its n_dl limb planes' y_l (d[l * LDD]): the
// top limb, then r = barrett(r * 256 + y_l) down to limb 0 (ntt_forward)
template <int LDD>
__device__ __forceinline__ int limb_horner(const int* d, int n_dl, int p,
                                           float inv_p) {
  int r = d[(n_dl - 1) * LDD];
  for (int l = n_dl - 2; l >= 0; --l)
    r = barrett(u32(r) * 256u + u32(d[l * LDD]), p, inv_p);
  return r;
}

// The pointwise sums of one (b, k): u[s][c] = sum_r d[r] * key[s, r, c],
// with a Barrett after every `rg` rows.  Group 2 (the Pallas kernel): the
// group partials are summed and reduced once more.  Group 3
// (pointwise_extprod, reduce_output=False): partials beyond two fold
// pairwise from the front, and the last two are added unreduced.  The row
// loop is outermost and not unrolled, so the group-end test runs once per
// row for all 2S sums, and the code holds one copy of the 2S-wide body.
// d[r] joins d_col[(r * n_dl + l) * LDD] over the limbs l; key[s, r, c] is
// k_col[((s * R + r) * 2 + c) * BN].
template <int G, int BN>
__device__ __forceinline__ void pointwise(const int* d_col, const int16_t* k_col,
                                          int R, int n_dl, int rg, int p,
                                          float inv_p,
                                          int (&u)[(1 << G) - 1][2]) {
  constexpr int S = (1 << G) - 1;
  constexpr int LDD = BN + 8;
  uint32_t part[S][2], acc[S][2];  // acc: the partials' sum (group 2) or
  int pend[S][2];                  // the folded prefix (group 3)
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      part[s][c] = 0u;
      acc[s][c] = 0u;
      pend[s][c] = 0;
    }
  int cnt = 0, have = 0;  // rows in the open group; partials so far (<= 2)
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    const uint32_t dr =
        u32(n_dl == 1 ? d_col[r * LDD]
                      : limb_horner<LDD>(d_col + r * n_dl * LDD, n_dl, p, inv_p));
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        part[s][c] += dr * u32(static_cast<int>(k_col[((s * R + r) * 2 + c) * BN]));
    if (++cnt == rg || r == R - 1) {
      cnt = 0;
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q = barrett(part[s][c], p, inv_p);
          part[s][c] = 0u;
          if constexpr (G == 2) {
            acc[s][c] += u32(q);
          } else if (have == 0) {
            acc[s][c] = u32(q);
          } else if (have == 1) {
            pend[s][c] = q;
          } else {
            acc[s][c] = u32(barrett(acc[s][c] + u32(pend[s][c]), p, inv_p));
            pend[s][c] = q;
          }
        }
      have = have < 2 ? have + 1 : 2;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if constexpr (G == 2)
        u[s][c] = barrett(acc[s][c], p, inv_p);
      else
        u[s][c] = static_cast<int>(have == 2 ? acc[s][c] + u32(pend[s][c])
                                             : acc[s][c]);
    }
}

// shared memory of one block: the ring, then two buffers of d_hat [BM][BN +
// 8] int32, the key tile [S * R * 2][BN] int16 and the tile's rotation
// amounts [G][TB] int32, then the barriers
__host__ __device__ constexpr int stage_bytes(int bn, int bk) {
  return BM * bk + 2 * bn * bk;
}
__host__ __device__ constexpr int key_tile_bytes(int group, int R, int bn) {
  return ((1 << group) - 1) * R * 2 * bn * 2;
}
__host__ __device__ constexpr int buffer_bytes(int group, int R, int bn) {
  return BM * (bn + 8) * 4 + key_tile_bytes(group, R, bn) + BM * group * 4;
}
// stages that fit beside the two buffers (at most kMaxStages)
__host__ __device__ constexpr int stages_that_fit(int group, int R, int bn, int bk) {
  const int left = kSmemCap - 1024 - kBuffers * buffer_bytes(group, R, bn) -
                   kBarrierBytes;
  const int n = left / stage_bytes(bn, bk);
  return n > kMaxStages ? kMaxStages : n;
}

// map_d:  int8 [B * R * n_dl, N] limb planes of the accumulator's gadget
//                               digits (plane r * n_dl + l), box [64, BK]
// map_lo, map_hi: int8 [P * N, N]  forward matrix limbs, transposed (k, j) so
//                               the contraction axis is contiguous, box [BN, BK]
// bsk:    int16 [S, P, R, 2, N] one step of the key (S = 2^G - 1 subsets)
// ts:     int32 [G, B]          rotation amounts in [0, 2N]
// rot:    int16 [P, 2N, N]      centered psi^{t(2k+1)}
// v:      int8 [P, B, 2, 2, N]  limb planes (lo, hi) of the residues
template <int G, int BN, int BK>
__global__ void __launch_bounds__(threads(G), 1)
ntt_step_fused_kernel(const __grid_constant__ CUtensorMap map_d,
                      const __grid_constant__ CUtensorMap map_lo,
                      const __grid_constant__ CUtensorMap map_hi,
                      const int16_t* __restrict__ bsk,
                      const int* __restrict__ ts,
                      const int16_t* __restrict__ rot, int8_t* __restrict__ v,
                      StepParams sp, int n_primes, int B, int R, int n_dl,
                      int N, int n_stages) {
  constexpr int S = (1 << G) - 1;
  constexpr int kPointwiseGroups = pointwise_groups(G);
  constexpr int kPointwiseThreads = 128 * kPointwiseGroups;
  constexpr int REGS = BN / 2;     // sums per thread of a 64 x BN tile
  constexpr int LDD = BN + 8;      // d_hat row stride (words): the int2 stores
                                   // of a half-warp hit 32 distinct banks
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tiles = align_1024(smem);
  unsigned char* bufs = tiles + n_stages * stage_bytes(BN, BK);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      bufs + kBuffers * buffer_bytes(G, R, BN));
  uint64_t* empty = full + kMaxStages;
  uint64_t* d_full = empty + kMaxStages;    // d_hat of a buffer is written
  uint64_t* d_empty = d_full + kBuffers;    // ... and has been read

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int RL = R * n_dl;                // limb planes per batch element
  const int tb = BM / RL;                 // batch elements per tile
  const int nrt = (B + tb - 1) / tb;      // row tiles
  const int nct = N / BN;                 // column tiles
  const int n_tiles = n_primes * nct * nrt;
  const int nk = N / BK;

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
      for (int id = blockIdx.x; kProduct && id < n_tiles; id += gridDim.x) {
        const int rt = id % nrt, ct = (id / nrt) % nct, pi = id / (nrt * nct);
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(empty + s, ph);
          unsigned char* st = tiles + s * stage_bytes(BN, BK);
          mbar_arrive_expect_tx(full + s, stage_bytes(BN, BK));
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
    reg_inc<product_regs(G)>();
    const int wt = tid & 127;
    const int lane = wt & 31, warp = wt >> 5;
    const int g = lane >> 2, t = lane & 3;
    const bool elected = wt == 0;
    int s = 0;
    uint32_t ph = 0;
    int j = 0;   // index of the tile in the block's order
    for (int id = blockIdx.x; id < n_tiles; id += gridDim.x, ++j) {
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
        const unsigned char* st = tiles + s * stage_bytes(BN, BK);
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

      // limb combine + Barrett -> d_hat, in the buffer the pointwise
      // warpgroups have finished with (its first use is free)
      const int buf = j % kBuffers;
      int* d_s = reinterpret_cast<int*>(bufs + buf * buffer_bytes(G, R, BN));
      mbar_wait(d_empty + buf, ((j / kBuffers) & 1) ^ 1);
      // a thread's two rows warp * 16 + g (+ 8) are limb planes l = row % n_dl
      const int* single_p = sp.single_add + pi * kMaxLimbs;
      const bool single0 = single_p[(warp * 16 + g) % n_dl] != 0;
      const bool single1 = single_p[(warp * 16 + g + 8) % n_dl] != 0;
#pragma unroll
      for (int i = 0; i < REGS; i += 2) {
        const bool single = (i / 2) % 2 ? single1 : single0;
        int y[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int lo = zlo[i + jj], hi = zhi[i + jj];
          y[jj] = single
                      ? barrett(u32(lo) + (u32(hi) << 8), p, inv_p)
                      : barrett(u32(barrett(u32(lo), p, inv_p)) +
                                    u32(barrett(u32(hi), p, inv_p)) * 256u,
                                p, inv_p);
        }
        const int r = warp * 16 + g + 8 * ((i / 2) % 2);
        const int c = 8 * (i / 4) + t * 2;
        *reinterpret_cast<int2*>(d_s + r * LDD + c) = make_int2(y[0], y[1]);
      }
      mbar_arrive(d_full + buf);   // all 128 threads: their stores are out
    }
  } else {
    // -- pointwise warpgroups: products with the key + subset combine -------
    const int pt = tid;                     // 0 .. kPointwiseThreads - 1
    const int k = pt % BN;
    constexpr int BSTEP = kPointwiseThreads / BN;
    int j = 0;
    for (int id = blockIdx.x; id < n_tiles; id += gridDim.x, ++j) {
      const int rt = id % nrt, ct = (id / nrt) % nct, pi = id / (nrt * nct);
      const int b0 = rt * tb;
      const int nb = min(tb, B - b0);        // live batch elements of the tile
      const int col0 = ct * BN;
      const int p = sp.p[pi];
      const float inv_p = sp.inv_p[pi];
      const int buf = j % kBuffers;
      int* d_s = reinterpret_cast<int*>(bufs + buf * buffer_bytes(G, R, BN));
      int16_t* k_s = reinterpret_cast<int16_t*>(d_s + BM * LDD);
      int* ts_s = reinterpret_cast<int*>(
          reinterpret_cast<unsigned char*>(k_s) + key_tile_bytes(G, R, BN));

      // the column tile's key residues: k_s[(s*R + r)*2 + c][k], 16 B loads.
      // (Every thread is past its reads of this buffer's tile j - 2: it has
      // passed the barrier below in tile j - 1.)
      for (int idx = pt; idx < S * R * 2 * (BN / 8); idx += kPointwiseThreads) {
        const int kr = idx / (BN / 8), c8 = idx % (BN / 8);
        const int s = kr / (2 * R), rc = kr % (2 * R);
        const int16_t* src =
            bsk + (static_cast<size_t>(s * n_primes + pi) * 2 * R + rc) * N +
            col0 + c8 * 8;
        *reinterpret_cast<int4*>(k_s + kr * BN + c8 * 8) =
            *reinterpret_cast<const int4*>(src);
      }
      // the tile's psi rows: ts_s[j * tb + b] = t_j(b0 + b) mod 2N
      for (int idx = pt; idx < G * nb; idx += kPointwiseThreads) {
        const int jj = idx / nb, b = idx % nb;
        ts_s[jj * tb + b] = ts[jj * B + b0 + b] & (2 * N - 1);
      }
      named_barrier_sync(1, kPointwiseThreads);   // key tile, rotations written
      mbar_wait(d_full + buf, (j / kBuffers) & 1);

      const int rg = sp.row_group[pi];
      const int16_t* rot_k = rot + static_cast<size_t>(pi) * 2 * N * N + col0 + k;
      // the psi values rot[p][t_j(b), k] are gathered two batch elements
      // ahead, so that their latency hides behind two elements' arithmetic
      auto gather = [&](int b, int (&r)[G]) {
#pragma unroll
        for (int jj = 0; jj < G; ++jj)
          r[jj] = b < nb ? rot_k[static_cast<size_t>(ts_s[jj * tb + b]) * N] : 1;
      };
      int raw1[G], raw2[G];
      gather(pt / BN, raw1);
      gather(pt / BN + BSTEP, raw2);
      for (int b = pt / BN; kPointwise && b < nb; b += BSTEP) {
        const int gb = b0 + b;
        int raw[G];
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          raw[jj] = raw1[jj];
          raw1[jj] = raw2[jj];
        }
        gather(b + 2 * BSTEP, raw2);
        int u[S][2];
        pointwise<G, BN>(d_s + b * RL * LDD + k, k_s + k, R, n_dl, rg, p,
                         inv_p, u);

        int out[2];
        if constexpr (G == 2) {
          const int d1 = raw[0] - 1, d2 = raw[1] - 1;
          const int d12 = barrett(u32(d1) * u32(d2), p, inv_p);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r1 = barrett(u32(d1) * u32(u[0][c]) + u32(d2) * u32(u[1][c]),
                                   p, inv_p);
            const int r2 = barrett(u32(d12) * u32(u[2][c]), p, inv_p);
            out[c] = barrett(u32(r1) + u32(r2), p, inv_p);
          }
        } else {
          // subset diagonals by binary DP: dm[m] = dm[m - low] * dm[low]
          int dm[1 << G];
          dm[0] = 0;
#pragma unroll
          for (int jj = 0; jj < G; ++jj) dm[1 << jj] = raw[jj] - 1;
#pragma unroll
          for (int m = 1; m < (1 << G); ++m)
            if (m & (m - 1)) {
              const int low = m & -m;
              dm[m] = barrett(u32(dm[m ^ low]) * u32(dm[low]), p, inv_p);
            }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint32_t sum = 0u;
#pragma unroll
            for (int m = 1; m < (1 << G); ++m)
              sum += u32(barrett(u32(dm[m]) * u32(u[m - 1][c]), p, inv_p));
            out[c] = barrett(sum, p, inv_p);
          }
        }
        // v == lo + 256 hi with lo in [-128, 128): K1's int8 limb planes
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int lo = ((out[c] + 128) & 255) - 128;
          int8_t* dst = v + ((static_cast<size_t>(pi) * B + gb) * 2 + c) * 2 * N +
                        col0 + k;
          dst[0] = static_cast<int8_t>(lo);
          dst[N] = static_cast<int8_t>((out[c] - lo) >> 8);
        }
      }
      mbar_arrive(d_empty + buf);   // all threads: the buffer's d_hat is read
    }
  }
}

// the matrix planes are constant per plan: their descriptors are encoded
// once per (pointer, shape, tile) and kept (per host thread)
struct MatrixMaps {
  const void* lo = nullptr;
  const void* hi = nullptr;
  int n = 0, primes = 0;
  CUtensorMap map_lo, map_hi;
};

template <int G, int BN, int BK>
int launch(const int8_t* digits, const int16_t* bsk, const int* ts,
           const int8_t* f_lo, const int8_t* f_hi, const int16_t* rot,
           int8_t* v, const StepParams& sp, int n_primes, int B, int R,
           int n_dl, int N, cudaStream_t stream) {
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
    const uint64_t dims[2] = {n64, static_cast<uint64_t>(B) * R * n_dl};
    const uint64_t strides[1] = {n64};
    const uint32_t box[2] = {BK, BM};
    const int e = make_tensor_map(&map_d, digits, 2, dims, strides, box);
    if (e) return e;
  }
  const int n_stages = stages_that_fit(G, R, BN, BK);
  const int bytes = 1024 + n_stages * stage_bytes(BN, BK) +
                    kBuffers * buffer_bytes(G, R, BN) + kBarrierBytes;
  // above 48 KB, dynamic shared memory needs the cap raised (per device)
  // (set once per device and size: the call costs host time on a host-bound path)
  thread_local int cap_device = -1, cap_bytes = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device != cap_device || bytes != cap_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_step_fused_kernel<G, BN, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap_device = device;
    cap_bytes = bytes;
  }
  const int tb = BM / (R * n_dl);
  const int n_tiles = n_primes * (N / BN) * ((B + tb - 1) / tb);
  const dim3 grid(n_tiles < sm_count() ? n_tiles : sm_count());
  ntt_step_fused_kernel<G, BN, BK><<<grid, threads(G), bytes, stream>>>(
      map_d, m.map_lo, m.map_hi, bsk, ts, rot, v, sp, n_primes, B, R, n_dl,
      N, n_stages);
  return static_cast<int>(cudaGetLastError());
}

// The tile is 64 x 128 when N allows it, that many tiles give every SM one,
// and at least 3 stages fit beside the consumers' buffers; else 64 x 32,
// with 64-byte stages when N is not a multiple of 128.
template <int G>
int dispatch(const int8_t* digits, const int16_t* bsk, const int* ts,
             const int8_t* f_lo, const int8_t* f_hi, const int16_t* rot,
             int8_t* v, const StepParams& sp, int n_primes, int B, int R,
             int n_dl, int N, cudaStream_t stream) {
  const int tb = BM / (R * n_dl);
  const int row_tiles = (B + tb - 1) / tb;
  if (N % 128 == 0 && n_primes * (N / 128) * row_tiles >= sm_count() &&
      stages_that_fit(G, R, 128, 128) >= 3)
    return launch<G, 128, 128>(digits, bsk, ts, f_lo, f_hi, rot, v, sp,
                               n_primes, B, R, n_dl, N, stream);
  if (N % 128 == 0)
    return launch<G, 32, 128>(digits, bsk, ts, f_lo, f_hi, rot, v, sp,
                              n_primes, B, R, n_dl, N, stream);
  return launch<G, 32, 64>(digits, bsk, ts, f_lo, f_hi, rot, v, sp, n_primes,
                           B, R, n_dl, N, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
// The caller guarantees: device pointers of the stated shapes, contiguous,
// 16-byte aligned; N % 64 == 0; 1 <= n_primes <= 8; digits of 1 <= n_dl <= 3
// limbs (more than one only at group 2) and 1 <= R * n_dl <= 10 limb planes
// a batch element; single_add holds n_primes * n_dl flags, (prime, limb).
extern "C" int ztfhe_ntt_step_fused(
    const int8_t* digits, const int16_t* bsk, const int* ts,
    const int8_t* f_lo, const int8_t* f_hi, const int16_t* rot, int8_t* v,
    const int* primes, const float* inv_p, const int* row_group,
    const int* single_add, int n_primes, int group, int B, int R, int n_dl,
    int N, void* stream) {
  if (n_primes < 1 || n_primes > kMaxPrimes || (group != 2 && group != 3) ||
      B < 1 || R < 1 || n_dl < 1 || n_dl > kMaxLimbs ||
      (group != 2 && n_dl != 1) || R * n_dl > kMaxRows || N < 64 ||
      N % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StepParams sp;
  for (int i = 0; i < kMaxPrimes; ++i) {
    const bool live = i < n_primes;
    sp.p[i] = live ? primes[i] : 1;
    sp.inv_p[i] = live ? inv_p[i] : 1.0f;
    sp.row_group[i] = live ? row_group[i] : 1;
    for (int l = 0; l < kMaxLimbs; ++l)
      sp.single_add[i * kMaxLimbs + l] =
          live && l < n_dl ? single_add[i * n_dl + l] : 1;
    if (sp.row_group[i] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return group == 2 ? dispatch<2>(digits, bsk, ts, f_lo, f_hi, rot, v, sp,
                                  n_primes, B, R, n_dl, N, s)
                    : dispatch<3>(digits, bsk, ts, f_lo, f_hi, rot, v, sp,
                                  n_primes, B, R, n_dl, N, s);
}

extern "C" const char* ztfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
