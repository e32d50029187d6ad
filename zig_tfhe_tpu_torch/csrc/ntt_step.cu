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
// g3's shape instance (template argument RC = 4).  g3's steps -- group 3,
// R = 4 one-limb rows, row groups 4 at p = 40,961 and 2 at 59,393 and
// 61,441, 64 x 128 tiles -- run an instance of their own whose pointwise
// stage is K2s's design (csrc/split_step.cu) at K2's arithmetic.  Measured
// before it (tools/torch_kernel_probe.py --split, g3, B = 2048, NVIDIA H100
// 80GB HBM3 at 700 W), the general instance took 354.3 us, 118.8 without
// its pointwise stage; without one part of that stage: the sums against
// the key 172.7, the subset DP and apply 319.0, the psi-row gather 307.5,
// the limb-plane stores 349.3; every Barrett as a shift 319.0.  The sums,
// 56 int16 key loads and a run-time row loop a lane, carried the time.
// So each pointwise thread runs kLanes = 8 lanes of its column (a tile's
// 16 lanes in its two threads; 4 lanes read 188.9 us, 2 lanes 196.0); the
// key tile is stored transposed, [S][BN][R][2] int16, so that one 16-byte
// load gives a subset's 8 residues of the column for all 8 lanes; R and
// the row group are compile-time (a body per row group,
// picked per tile from its prime), so the fold has no run-time branch; the
// lanes' psi rows are gathered before the key tile is staged; each subset's
// sums go straight into its term of the apply; every Barrett of the stage
// rounds by an f32 add (barrett_add); and the product warpgroup is capped
// at 168 registers, which gives the pointwise threads 160 (ptxas: 128 at
// launch, no spills).  Measured the same way, it takes 182.2 us: 108.2
// without its pointwise stage, 130.9 without its product stage; without
// the sums 153.1, the DP and apply 164.8, the gather 169.3, the stores
// 176.7; every Barrett as a shift 162.6.  The stages now overlap only in
// part, and the product stage alone (its ~1 GB of L2 -> SM traffic a
// call) is the next floor: the cluster multicast above.  Every other
// launch (group 2 outside the uint keys' instance below, group 3 at
// another R or row group, the narrow tiles) runs the general instance (RC
// = 0), whose code is unchanged.  Tried and slower on the same card (CUDA graphs, g3, B =
// 2048): the forward combine's Barretts by the f32 add (196 against 183
// us); the next tile's psi values fetched into registers during this
// tile's (198 against 181), also with its key tile by cp.async into the
// other buffer, untransposed (196 against 183).
//
// The uint keys' instance (template argument RC = kUintRows = 2 at G = 2).
// The steps of uint2 to uint8 -- group 2, R = 2 rows of 3-limb digits (Bg_e
// 2^18 to 2^23 at (1, 1) levels), row group 2 at every prime, 64 x 128
// tiles of 10 lanes -- run an instance of their own.  Measured before it
// (tools/torch_kernel_probe.py --split, uint4, B = 2048, NVIDIA H100 80GB
// HBM3 at 700 W), the general instance took 465.2 us, 362.6 without its
// pointwise stage, 354.5 without its product stage; without the sums and
// the Horner join 399.7, the combine 445.0, the gather 440.3, the stores
// 462.9; every Barrett as a shift 411.1.  Its thread walked the tile's 10
// lanes 3 at a time (4 rounds, 2 of the last round's 3 lanes idle), each
// lane reading its 12 key residues from shared memory one at a time, with
// R, n_dl and the row group at run time.  So this instance's pointwise
// threads run kUintLanes = 5 lanes of a column (a tile's 10 lanes in its
// two threads, no idle round), the column's 12 key residues and the
// lanes' psi values loaded into registers straight from device memory
// before d_hat is waited for (no key tile, no barrier), R, n_dl, the row
// group and the Horner compile-time, every Barrett by the f32 add; the
// product warpgroup has 168 registers, the pointwise threads 160 (ptxas:
// 128 at launch, no spills).  With that alone the pointwise stage alone
// fell to 143.8 us, but the whole only to 429.6: the product stage alone
// read 348.2 and every Barrett as a shift 281.5, so the product
// warpgroup's forward combine -- 1 or 3 conversion Barretts a value, its
// limb branches divergent in every warp, serial with the warpgroup's
// wgmmas -- held the kernel.  So this instance's product warpgroup leaves
// each plane's last Barrett to the pointwise threads: it stores lo + (hi
// << 8) where the single add holds, else barrett(lo) and barrett(hi) as
// int16 halves, f32-add Barretts picked by a select (none at a prime whose
// limbs all take the single add), and keeps d_hat's 60 plane rows alone,
// which with no key tile leaves room for a fourth stage.  Measured the
// same way, it takes 342.9 us: 261.7 without its pointwise stage, 155.9
// without its product stage; without the sums 314.2, the combine 335.0,
// the gather 338.1, the stores 342.6; every Barrett as a shift 308.4; the
// parent's general instance 460-477 us and this one 335-340 in turns
// from CUDA graphs.  The product stage alone (~2.7 GB of L2 -> SM
// traffic a launch, 10 TB/s) is the next floor: the cluster multicast
// above.  Tried and slower or no better (the same card, in turns): the
// general epilogue with f32-add Barretts (398-407 us) or with selects
// for its branches (conversion 387-390, f32 add 375-384), the latter
// with d_hat as int16 and four stages (361-376) or with three d_hat
// buffers (363-380), the Horner's or the planes' Barretts by conversion
// (379-381, 362-363), the packed planes in all 64 rows and three stages
// (355-366) or behind a divergent branch (418-422), one pointwise
// warpgroup of 10 lanes a thread (427-504); and, timed in a K2 + K1 step
// loop, the next tile's psi values and keys fetched during this tile's,
// or a psi table of N rows (psi^{(t + N)(2k + 1)} = -psi^{t(2k + 1)}).
// In that loop, as in the cell, the instance reads ~375-383 us against
// ~340 alone (the general instance ~10 us more than alone); why is open.
//
// Exactness.  Barrett is round(f32(x) * f32(1/p)) half to even
// (__float2int_rn(__fmul_rn(__int2float_rn(x), inv_p))), like jnp.round;
// the shape instances' pointwise stages (and the uint keys' forward
// combine) compute the same function with the rounding as an f32 add
// (barrett_add, exact for p >= 2^11; the check kernels hold the two equal
// on every int32); every wrapping sum and
// product is uint32 (signed overflow is undefined in C++); the build passes
// -fmad=false.  Since every Barrett sees the same int32 as in the plain
// version, the two are compared for equality.


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
// The two shape instances (RC != 0) run two pointwise warpgroups at either
// group.
__host__ __device__ constexpr int pointwise_groups(int group, int rc = 0) {
  return group == 2 && rc == 0 ? 3 : 2;
}
__host__ __device__ constexpr int threads(int group, int rc = 0) {
  return 128 * (pointwise_groups(group, rc) + 2);
}
// registers a thread: the launch gives every thread base_regs; the producer
// keeps 24 and the product warpgroup takes what that frees
__host__ __device__ constexpr int base_regs(int group) {
  return 65536 / threads(group) / 8 * 8;
}
__host__ __device__ constexpr int product_regs(int group) {
  return 2 * base_regs(group) - 24 > 232 ? 232 : 2 * base_regs(group) - 24;
}
// The instance compiled at g3's shape (group 3, R = kShapeRows one-limb
// digit rows, row groups 4 or 2, 64 x 128 tiles): the product warpgroup
// takes the 168 registers its 128 sums and epilogue need (K2s's at the
// same tile), the pointwise warpgroups share the rest of what the
// producer frees; each pointwise thread runs kLanes lanes of its column.
constexpr int kShapeRows = 4;
constexpr int kLanes = 8;
constexpr int kShapeProductRegs = 168;
constexpr int kShapePointwiseRegs =
    base_regs(3) + ((base_regs(3) - 24) - (kShapeProductRegs - base_regs(3))) *
                       128 / (128 * pointwise_groups(3)) / 8 * 8;
static_assert(kShapePointwiseRegs == 160, "registers");
// The instance compiled at the uint keys' shape (group 2, R = kUintRows
// digit rows of kUintLimbs int8 limbs, row group 2 at every prime, 64 x 128
// tiles of 10 lanes, whose 60 limb planes are the only d_hat rows it keeps):
// the block, registers included, is the g3 instance's, and each pointwise
// thread runs kUintLanes lanes of its column.
constexpr int kUintRows = 2;
constexpr int kUintLimbs = 3;
constexpr int kUintLanes = 5;
constexpr int kUintPlaneRows = 60;   // (64 / (R n_dl)) lanes x R n_dl planes
// its planes carry Barretts as int16 halves: |barrett| <= p/2 + 320 < 2^15
constexpr int kMaxPackedPrime = 2 * (32767 - 320);
static_assert(threads(2, kUintRows) == threads(3, kShapeRows), "registers");
constexpr int kMinPrime = 2048;   // barrett_add's rounding is exact for p >= 2^11
constexpr int kBuffers = 2;     // d_hat buffers between product and pointwise
constexpr int kMaxStages = 8;
constexpr int kSmemCap = 232448;   // bytes a block can use on this card
// full[kMaxStages], empty[kMaxStages], d_full[kBuffers], d_empty[kBuffers]
constexpr int kBarrierBytes = (2 * kMaxStages + 2 * kBuffers) * 8;

// Stage switches for tools/torch_kernel_probe.py --split only (the results
// are then wrong): -DZTFHE_PROBE_NO_PRODUCT drops the TMA loads and the
// wgmmas, -DZTFHE_PROBE_NO_POINTWISE the per-(b, k) stage after d_hat.
// One part of the pointwise stage each, its results kept live:
// -DZTFHE_PROBE_NO_SUMS drops the sums against the key (u is a digit
// row), -DZTFHE_PROBE_NO_COMBINE the subset DP and apply (v is the sum of
// the u), -DZTFHE_PROBE_NO_GATHER the psi-row loads (a rotation amount
// stands in), -DZTFHE_PROBE_NO_STORES the limb-plane stores (one store
// left behind a test the values never pass); -DZTFHE_PROBE_BARRETT_IMAD
// replaces each Barrett's conversions and multiply by a shift.
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
#ifdef ZTFHE_PROBE_NO_SUMS
constexpr bool kSums = false;
#else
constexpr bool kSums = true;
#endif
#ifdef ZTFHE_PROBE_NO_COMBINE
constexpr bool kCombine = false;
#else
constexpr bool kCombine = true;
#endif
#ifdef ZTFHE_PROBE_NO_GATHER
constexpr bool kGather = false;
#else
constexpr bool kGather = true;
#endif
#ifdef ZTFHE_PROBE_NO_STORES
constexpr bool kStores = false;
#else
constexpr bool kStores = true;
#endif
constexpr int kNever = 0x7ACE0000;   // no residue is this large

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
#ifdef ZTFHE_PROBE_BARRETT_IMAD
  const uint32_t q = x >> 16;
#else
  const int q = __float2int_rn(__fmul_rn(__int2float_rn(static_cast<int>(x)), inv_p));
#endif
  return static_cast<int>(x - u32(q) * u32(p));
}

// The same function with the rounding off the conversion pipe (the shape
// instance's pointwise stage): adding 1.5 * 2^23 rounds f = f32(x) *
// f32(1/p) to an integer, half to even, in the mantissa of r, exactly
// while |f| < 2^22; |x| <= 2^31 and p >= 2^11 (the entry point refuses
// smaller primes for that instance) keep |f| <= 2^20.  The check kernels
// below hold it to barrett() on every int32.
__device__ __forceinline__ int barrett_add(uint32_t x, int p, float inv_p) {
#ifdef ZTFHE_PROBE_BARRETT_IMAD
  const uint32_t q = x >> 16;
#else
  const float r = __fadd_rn(__fmul_rn(__int2float_rn(static_cast<int>(x)), inv_p),
                            12582912.0f);
  const uint32_t q = u32(__float_as_int(r) - 0x4B400000);
#endif
  return static_cast<int>(x - q * u32(p));
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
  if constexpr (!kSums) {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < 2; ++c) u[s][c] = d_col[0] ^ (2 * s + c);
    return;
  }
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

// The shape instance's group-3 step for kLanes lanes (b, k), (b + 1, k), ...
// of one column: the subset diagonals by the DP of the general instance,
// then one subset at a time its pointwise sums (each key residue read once
// for all the lanes: key[s][r][c] is k_col[s * BN * 8 + r * 2 + c], one
// 16-byte load a subset) and its term of the apply, then the final
// Barrett: pointwise_extprod(reduce_output=False) and rotate_combine_multi
// (u_wide) with every reduction where they place it.  RG, the prime's row
// group: 4, one partial, u its Barrett; 2, two partials, u the unreduced
// sum of their Barretts.  d_col: the lanes' d_hat rows, lane l row r at
// d_col[(l * R + r) * LDD]; raw: the lanes' psi values rot[t_j(b)][k].
template <int BN, int RG>
__device__ __forceinline__ void shape_lanes(const int* d_col, const int16_t* k_col,
                                            const int (&raw)[kLanes][3], int p,
                                            float inv_p, int (&out)[kLanes][2]) {
  constexpr int R = kShapeRows, S = 7;
  constexpr int LDD = BN + 8;
  static_assert(RG == 4 || RG == 2, "row group");
  int d[kLanes][R];
#pragma unroll
  for (int l = 0; l < kLanes; ++l)
#pragma unroll
    for (int r = 0; r < R; ++r) d[l][r] = d_col[(l * R + r) * LDD];
  // subset diagonals dm[m] = dm[m - low] * dm[low] (rotate_combine_multi)
  int dm[kLanes][8];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) {
#pragma unroll
    for (int jj = 0; jj < 3; ++jj) dm[l][1 << jj] = raw[l][jj] - 1;
#pragma unroll
    for (int m = 3; m < 8; ++m)
      if (m & (m - 1)) {
        const int low = m & -m;
        dm[l][m] = kCombine ? barrett_add(u32(dm[l][m ^ low]) * u32(dm[l][low]),
                                          p, inv_p)
                            : dm[l][m ^ low] ^ dm[l][low];
      }
  }
  uint32_t sum[kLanes][2];
#pragma unroll
  for (int l = 0; l < kLanes; ++l) sum[l][0] = sum[l][1] = 0u;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int4 kv = *reinterpret_cast<const int4*>(k_col + s * BN * 8);
    const int w[R] = {kv.x, kv.y, kv.z, kv.w};
    uint32_t key[R][2];   // word r: (r, c = 0) in the low half, (r, 1) high
#pragma unroll
    for (int r = 0; r < R; ++r) {
      key[r][0] = u32(static_cast<int>(u32(w[r]) << 16) >> 16);
      key[r][1] = u32(w[r] >> 16);
    }
#pragma unroll
    for (int l = 0; l < kLanes; ++l)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int u;
        if constexpr (!kSums) {
          u = d[l][(s + c) % R];
        } else if constexpr (RG == 4) {
          uint32_t part = 0u;
#pragma unroll
          for (int r = 0; r < R; ++r) part += u32(d[l][r]) * key[r][c];
          u = barrett_add(part, p, inv_p);
        } else {
          const uint32_t p0 = u32(d[l][0]) * key[0][c] + u32(d[l][1]) * key[1][c];
          const uint32_t p1 = u32(d[l][2]) * key[2][c] + u32(d[l][3]) * key[3][c];
          u = static_cast<int>(u32(barrett_add(p0, p, inv_p)) +
                               u32(barrett_add(p1, p, inv_p)));
        }
        sum[l][c] += kCombine ? u32(barrett_add(u32(dm[l][s + 1]) * u32(u), p, inv_p))
                              : u32(u) ^ u32(dm[l][s + 1]);
      }
  }
#pragma unroll
  for (int l = 0; l < kLanes; ++l)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      out[l][c] = kCombine ? barrett_add(sum[l][c], p, inv_p)
                           : static_cast<int>(sum[l][c]);
}

// The uint instance's group-2 step for kUintLanes lanes (b, k), (b + 1, k),
// ... of one column, from what its product warpgroup left of each limb
// plane (a word w: the single add lo + (hi << 8) where single[q] holds for
// the plane's limb q, else barrett(lo) and barrett(hi) as its low and high
// int16 halves): the plane's last Barrett y_q = barrett(w) or
// barrett(lo' + 256 hi'), each digit row joined by Horner (limb_horner),
// its pointwise sums against the column's key residues (held in registers
// for all the lanes: key[s][r][c]), then the combine
// barrett(barrett(d1 u1 + d2 u2) + barrett(d12 u12)): the general
// instance's arithmetic at R = kUintRows, n_dl = kUintLimbs and row group
// 2, Barrett for Barrett, each rounded by the f32 add.  d_col: the lanes'
// plane words, lane l row r limb q at d_col[((l * R + r) * L + q) * LDD];
// raw: the lanes' psi values rot[t_j(b)][k].
template <int BN>
__device__ __forceinline__ void uint_lanes(const int* d_col,
                                           const bool (&single)[kUintLimbs],
                                           const int (&key)[3][kUintRows][2],
                                           const int (&raw)[kUintLanes][2], int p,
                                           float inv_p, int (&out)[kUintLanes][2]) {
  constexpr int R = kUintRows, L = kUintLimbs, LDD = BN + 8;
#pragma unroll
  for (int l = 0; l < kUintLanes; ++l) {
    uint32_t d[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int* row = d_col + (l * R + r) * L * LDD;
      auto y = [&](int q) {
        const int w = row[q * LDD];
        return barrett_add(single[q] ? u32(w)
                                     : u32(static_cast<int16_t>(w & 0xFFFF)) +
                                           u32(w >> 16) * 256u,
                           p, inv_p);
      };
      int x = row[(L - 1) * LDD];
      if constexpr (kSums) {
        x = y(L - 1);
#pragma unroll
        for (int q = L - 2; q >= 0; --q)
          x = barrett_add(u32(x) * 256u + u32(y(q)), p, inv_p);
      }
      d[r] = u32(x);
    }
    int u[3][2];
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if constexpr (!kSums) {
          u[s][c] = static_cast<int>(d[(s + c) % R] ^ u32(2 * s + c));
        } else {
          // one row group: u = barrett of the group's Barrett (pointwise())
          const uint32_t part = d[0] * u32(key[s][0][c]) + d[1] * u32(key[s][1][c]);
          u[s][c] = barrett_add(u32(barrett_add(part, p, inv_p)), p, inv_p);
        }
      }
    if constexpr (!kCombine) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
        out[l][c] = static_cast<int>(u32(raw[l][1]) + u32(u[0][c]) + u32(u[1][c]) +
                                     u32(u[2][c]));
    } else {
      const int d1 = raw[l][0] - 1, d2 = raw[l][1] - 1;
      const int d12 = barrett_add(u32(d1) * u32(d2), p, inv_p);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r1 =
            barrett_add(u32(d1) * u32(u[0][c]) + u32(d2) * u32(u[1][c]), p, inv_p);
        const int r2 = barrett_add(u32(d12) * u32(u[2][c]), p, inv_p);
        out[l][c] = barrett_add(u32(r1) + u32(r2), p, inv_p);
      }
    }
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
// (the uint keys' instance: d_hat's 60 plane rows alone, which leaves room
// for a fourth stage)
__host__ __device__ constexpr int buffer_bytes(int group, int R, int bn, int rc = 0) {
  return group == 2 && rc
             ? kUintPlaneRows * (bn + 8) * 4
             : BM * (bn + 8) * 4 + key_tile_bytes(group, R, bn) + BM * group * 4;
}
// stages that fit beside the two buffers (at most kMaxStages)
__host__ __device__ constexpr int stages_that_fit(int group, int R, int bn, int bk,
                                                  int rc = 0) {
  const int left = kSmemCap - 1024 - kBuffers * buffer_bytes(group, R, bn, rc) -
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
// RC: 0 for the general instance (R and n_dl at run time), kShapeRows for
// g3's shape instance (group 3, R = RC one-limb rows, BN = 128, every row
// group 4 or 2, every prime >= kMinPrime), kUintRows for the uint keys'
// (group 2, R = RC rows of kUintLimbs limbs, BN = 128, every row group 2,
// every prime >= kMinPrime); the entry point checks them
template <int G, int BN, int BK, int RC>
__global__ void __launch_bounds__(threads(G, RC), 1)
ntt_step_fused_kernel(const __grid_constant__ CUtensorMap map_d,
                      const __grid_constant__ CUtensorMap map_lo,
                      const __grid_constant__ CUtensorMap map_hi,
                      const int16_t* __restrict__ bsk,
                      const int* __restrict__ ts,
                      const int16_t* __restrict__ rot, int8_t* __restrict__ v,
                      StepParams sp, int n_primes, int B, int R_arg,
                      int n_dl_arg, int N, int n_stages) {
  static_assert(RC == 0 || (G == 3 && RC == kShapeRows && BN == 128) ||
                    (G == 2 && RC == kUintRows && BN == 128),
                "shape");
  const int R = RC ? RC : R_arg;
  const int n_dl = RC == 0 ? n_dl_arg : G == 2 ? kUintLimbs : 1;
  constexpr int S = (1 << G) - 1;
  constexpr int kPointwiseGroups = pointwise_groups(G, RC);
  constexpr int kPointwiseThreads = 128 * kPointwiseGroups;
  constexpr int REGS = BN / 2;     // sums per thread of a 64 x BN tile
  constexpr int LDD = BN + 8;      // d_hat row stride (words): the int2 stores
                                   // of a half-warp hit 32 distinct banks
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tiles = align_1024(smem);
  unsigned char* bufs = tiles + n_stages * stage_bytes(BN, BK);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      bufs + kBuffers * buffer_bytes(G, R, BN, RC));
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
    reg_inc<RC ? kShapeProductRegs : product_regs(G)>();
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
      int* d_s = reinterpret_cast<int*>(bufs + buf * buffer_bytes(G, R, BN, RC));
      mbar_wait(d_empty + buf, ((j / kBuffers) & 1) ^ 1);
      // a thread's two rows warp * 16 + g (+ 8) are limb planes l = row % n_dl
      const int* single_p = sp.single_add + pi * kMaxLimbs;
      const bool single0 = single_p[(warp * 16 + g) % n_dl] != 0;
      const bool single1 = single_p[(warp * 16 + g + 8) % n_dl] != 0;
      if constexpr (G == 2 && RC != 0) {
        // the uint keys' instance leaves each plane's last Barrett to the
        // pointwise threads (uint_lanes): it stores the single add lo + (hi
        // << 8) where that holds, else barrett(lo) and barrett(hi) packed
        // as int16 halves (|barrett| <= p/2 + 320 < 2^15: every prime <=
        // kMaxPackedPrime; a plan's are <= 63,000), picked by a select, so
        // that the warp, whose rows hold all three limbs, does not diverge;
        // at a prime where every limb takes the single add, no Barrett.
        // Only the 60 plane rows are kept.
        const bool all_single = single_p[0] && single_p[1] && single_p[2];
#pragma unroll
        for (int i = 0; i < REGS; i += 2) {
          const bool single = (i / 2) % 2 ? single1 : single0;
          int w[2];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int lo = zlo[i + jj], hi = zhi[i + jj];
            const uint32_t sum = u32(lo) + (u32(hi) << 8);
            uint32_t packed = sum;
            if (!all_single)
              packed = (u32(barrett_add(u32(lo), p, inv_p)) & 0xFFFFu) |
                       (u32(barrett_add(u32(hi), p, inv_p)) << 16);
            w[jj] = static_cast<int>(single ? sum : packed);
          }
          const int r = warp * 16 + g + 8 * ((i / 2) % 2);
          const int c = 8 * (i / 4) + t * 2;
          if (r < kUintPlaneRows)
            *reinterpret_cast<int2*>(d_s + r * LDD + c) = make_int2(w[0], w[1]);
        }
      } else {
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
      }
      mbar_arrive(d_full + buf);   // all 128 threads: their stores are out
    }
  } else if constexpr (G == 2 && RC != 0) {
    // -- pointwise warpgroups at the uint keys' shape: thread = column k and
    // the kUintLanes lanes l0 .. l0 + kUintLanes - 1 of the tile; the
    // column's 12 key residues and the lanes' psi values are loaded into
    // registers straight from device memory, in flight while d_hat is
    // finished ---------------------------------------------------------------
    reg_inc<kShapePointwiseRegs>();
    const int pt = tid;
    const int k = pt % BN;
    const int l0 = pt / BN * kUintLanes;
    static_assert(kPointwiseThreads / BN * kUintLanes == BM / (RC * kUintLimbs),
                  "lanes");
    int j = 0;
    for (int id = blockIdx.x; id < n_tiles; id += gridDim.x, ++j) {
      const int rt = id % nrt, ct = (id / nrt) % nct, pi = id / (nrt * nct);
      const int b0 = rt * tb;
      const int nb = min(tb, B - b0);        // live batch elements of the tile
      const int col0 = ct * BN;
      const int p = sp.p[pi];
      const float inv_p = sp.inv_p[pi];
      const int buf = j % kBuffers;
      const int* d_s =
          reinterpret_cast<const int*>(bufs + buf * buffer_bytes(G, R, BN, RC));
      const int16_t* rot_k = rot + static_cast<size_t>(pi) * 2 * N * N + col0 + k;
      // (lanes past nb read lane 0's psi values)
      int raw[kUintLanes][2];
#pragma unroll
      for (int l = 0; l < kUintLanes; ++l) {
        const int b = l0 + l < nb ? l0 + l : 0;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int t = ts[jj * B + b0 + b] & (2 * N - 1);
          raw[l][jj] = kGather ? rot_k[static_cast<size_t>(t) * N] : t;
        }
      }
      // key[s][r][c] = bsk[s, pi, r, c, col0 + k]
      int key[S][RC][2];
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int r = 0; r < RC; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            key[s][r][c] = bsk[(static_cast<size_t>(s * n_primes + pi) * 2 * RC +
                                r * 2 + c) * N + col0 + k];
      mbar_wait(d_full + buf, (j / kBuffers) & 1);

      if (kPointwise && l0 < nb) {
        int out[kUintLanes][2];
        const bool single[kUintLimbs] = {sp.single_add[pi * kMaxLimbs] != 0,
                                         sp.single_add[pi * kMaxLimbs + 1] != 0,
                                         sp.single_add[pi * kMaxLimbs + 2] != 0};
        uint_lanes<BN>(d_s + l0 * RC * kUintLimbs * LDD + k, single, key, raw, p,
                       inv_p, out);
        // v == lo + 256 hi with lo in [-128, 128): K1's int8 limb planes
#pragma unroll
        for (int l = 0; l < kUintLanes; ++l) {
          if (l0 + l >= nb) break;
          const int gb = b0 + l0 + l;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int lo = ((out[l][c] + 128) & 255) - 128;
            int8_t* dst = v + ((static_cast<size_t>(pi) * B + gb) * 2 + c) * 2 * N +
                          col0 + k;
            if (kStores || out[l][c] == kNever) {
              dst[0] = static_cast<int8_t>(lo);
              dst[N] = static_cast<int8_t>((out[l][c] - lo) >> 8);
            }
          }
        }
      }
      mbar_arrive(d_empty + buf);   // all threads: the buffer's d_hat is read
    }
  } else if constexpr (RC != 0) {
    // -- pointwise warpgroups at g3's shape: thread = column k and the
    // kLanes lanes l0 .. l0 + kLanes - 1 of the tile, each key load serving
    // them all ----------------------------------------------------------------
    reg_inc<kShapePointwiseRegs>();
    const int pt = tid;
    const int k = pt % BN;
    const int l0 = pt / BN * kLanes;
    static_assert(kPointwiseThreads / BN * kLanes * RC == BM, "lanes");
    int j = 0;
    for (int id = blockIdx.x; id < n_tiles; id += gridDim.x, ++j) {
      const int rt = id % nrt, ct = (id / nrt) % nct, pi = id / (nrt * nct);
      const int b0 = rt * tb;
      const int nb = min(tb, B - b0);        // live batch elements of the tile
      const int col0 = ct * BN;
      const int p = sp.p[pi];
      const float inv_p = sp.inv_p[pi];
      const int buf = j % kBuffers;
      const int* d_s = reinterpret_cast<const int*>(bufs + buf * buffer_bytes(G, R, BN));
      int16_t* k_s = reinterpret_cast<int16_t*>(
          bufs + buf * buffer_bytes(G, R, BN) + BM * LDD * 4);
      const int16_t* rot_k = rot + static_cast<size_t>(pi) * 2 * N * N + col0 + k;

      // the psi values of the thread's lanes, in flight while the key tile
      // is staged and d_hat finished (lanes past nb read lane 0's)
      int raw[kLanes][3];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) {
        const int b = l0 + l < nb ? l0 + l : 0;
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          const int t = ts[jj * B + b0 + b] & (2 * N - 1);
          raw[l][jj] = kGather ? rot_k[static_cast<size_t>(t) * N] : t;
        }
      }
      // the column tile's key residues, transposed to k_s[(s * BN + k) * 8 +
      // r * 2 + c]: each (subset, 8 columns) read as the 8 (r, c) rows' 16
      // bytes and stored as 8 columns' 16 bytes.  (Every thread is past its
      // reads of this buffer's tile j - 2: it has passed the barrier below
      // in tile j - 1.)
      for (int idx = pt; idx < S * (BN / 8); idx += kPointwiseThreads) {
        const int s = idx / (BN / 8), c8 = idx % (BN / 8);
        const int16_t* src =
            bsk + static_cast<size_t>(s * n_primes + pi) * 2 * RC * N + col0 + c8 * 8;
        int4 w[2 * RC];
#pragma unroll
        for (int rc = 0; rc < 2 * RC; ++rc)
          w[rc] = *reinterpret_cast<const int4*>(src + static_cast<size_t>(rc) * N);
        const uint16_t* hw[2 * RC];
#pragma unroll
        for (int rc = 0; rc < 2 * RC; ++rc)
          hw[rc] = reinterpret_cast<const uint16_t*>(&w[rc]);
        int4* dst = reinterpret_cast<int4*>(k_s + (s * BN + c8 * 8) * 8);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          int q[RC];
#pragma unroll
          for (int r = 0; r < RC; ++r)
            q[r] = static_cast<int>(hw[2 * r][e] | (u32(hw[2 * r + 1][e]) << 16));
          dst[e] = make_int4(q[0], q[1], q[2], q[3]);
        }
      }
      named_barrier_sync(1, kPointwiseThreads);   // key tile written
      mbar_wait(d_full + buf, (j / kBuffers) & 1);

      if (kPointwise && l0 < nb) {
        const int* d_col = d_s + l0 * RC * LDD + k;
        const int16_t* k_col = k_s + k * 8;
        int out[kLanes][2];
        if (sp.row_group[pi] == 4)
          shape_lanes<BN, 4>(d_col, k_col, raw, p, inv_p, out);
        else
          shape_lanes<BN, 2>(d_col, k_col, raw, p, inv_p, out);
        // v == lo + 256 hi with lo in [-128, 128): K1's int8 limb planes
#pragma unroll
        for (int l = 0; l < kLanes; ++l) {
          if (l0 + l >= nb) break;
          const int gb = b0 + l0 + l;
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int lo = ((out[l][c] + 128) & 255) - 128;
            int8_t* dst = v + ((static_cast<size_t>(pi) * B + gb) * 2 + c) * 2 * N +
                          col0 + k;
            if (kStores || out[l][c] == kNever) {
              dst[0] = static_cast<int8_t>(lo);
              dst[N] = static_cast<int8_t>((out[l][c] - lo) >> 8);
            }
          }
        }
      }
      mbar_arrive(d_empty + buf);   // all threads: the buffer's d_hat is read
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
          r[jj] = b < nb ? (kGather ? rot_k[static_cast<size_t>(ts_s[jj * tb + b]) * N]
                                    : ts_s[jj * tb + b])
                         : 1;
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
        if constexpr (!kCombine) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            uint32_t sum = u32(raw[G - 1]);
#pragma unroll
            for (int s = 0; s < S; ++s) sum += u32(u[s][c]);
            out[c] = static_cast<int>(sum);
          }
        } else if constexpr (G == 2) {
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
          if (kStores || out[c] == kNever) {
            dst[0] = static_cast<int8_t>(lo);
            dst[N] = static_cast<int8_t>((out[c] - lo) >> 8);
          }
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

template <int G, int BN, int BK, int RC>
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
  const int n_stages = stages_that_fit(G, R, BN, BK, RC);
  const int bytes = 1024 + n_stages * stage_bytes(BN, BK) +
                    kBuffers * buffer_bytes(G, R, BN, RC) + kBarrierBytes;
  // above 48 KB, dynamic shared memory needs the cap raised (per device)
  // (set once per device and size: the call costs host time on a host-bound path)
  thread_local int cap_device = -1, cap_bytes = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device != cap_device || bytes != cap_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        ntt_step_fused_kernel<G, BN, BK, RC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap_device = device;
    cap_bytes = bytes;
  }
  const int tb = BM / (R * n_dl);
  const int n_tiles = n_primes * (N / BN) * ((B + tb - 1) / tb);
  const dim3 grid(n_tiles < sm_count() ? n_tiles : sm_count());
  ntt_step_fused_kernel<G, BN, BK, RC><<<grid, threads(G, RC), bytes, stream>>>(
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
    return launch<G, 128, 128, 0>(digits, bsk, ts, f_lo, f_hi, rot, v, sp,
                                  n_primes, B, R, n_dl, N, stream);
  if (N % 128 == 0)
    return launch<G, 32, 128, 0>(digits, bsk, ts, f_lo, f_hi, rot, v, sp,
                                 n_primes, B, R, n_dl, N, stream);
  return launch<G, 32, 64, 0>(digits, bsk, ts, f_lo, f_hi, rot, v, sp, n_primes,
                              B, R, n_dl, N, stream);
}

// r[i] = barrett_add(x[i]) for i < n: the shape instances' Barrett on
// chosen inputs
__global__ void barrett_kernel(const int* __restrict__ x, int* __restrict__ r,
                               int n, int p, float inv_p) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    r[i] = barrett_add(u32(x[i]), p, inv_p);
}

// the inputs x = start + i (mod 2^32), 0 <= i < count, on which barrett_add
// and barrett differ, counted into *n_diff
__global__ void barrett_check_kernel(uint32_t start, unsigned long long count,
                                     int p, float inv_p,
                                     unsigned long long* n_diff) {
  unsigned long long c = 0;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += stride) {
    const uint32_t x = start + static_cast<uint32_t>(i);
    c += barrett_add(x, p, inv_p) != barrett(x, p, inv_p);
  }
  if (c) atomicAdd(n_diff, c);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
// The caller guarantees: device pointers of the stated shapes, contiguous,
// 16-byte aligned; N % 64 == 0; 1 <= n_primes <= 8; digits of 1 <= n_dl <= 3
// limbs (more than one only at group 2) and 1 <= R * n_dl <= 10 limb planes
// a batch element; single_add holds n_primes * n_dl flags, (prime, limb).
// `shape` picks the instance: 0 the general one; 1 the one compiled at g3's
// shape, on 64 x 128 tiles, refused unless the launch has that shape: group
// 3, R = kShapeRows one-limb rows, N % 128 == 0, every row group 4 or 2
// and every prime >= 2^11 (where its Barrett is exact); 2 the one compiled
// at the uint keys' shape, on 64 x 128 tiles, refused unless group 2, R =
// kUintRows rows of kUintLimbs limbs, N % 128 == 0, every row group 2 and
// every prime in [2^11, kMaxPackedPrime].
extern "C" int ztfhe_ntt_step_fused(
    const int8_t* digits, const int16_t* bsk, const int* ts,
    const int8_t* f_lo, const int8_t* f_hi, const int16_t* rot, int8_t* v,
    const int* primes, const float* inv_p, const int* row_group,
    const int* single_add, int n_primes, int group, int B, int R, int n_dl,
    int N, int shape, void* stream) {
  if (n_primes < 1 || n_primes > kMaxPrimes || (group != 2 && group != 3) ||
      B < 1 || R < 1 || n_dl < 1 || n_dl > kMaxLimbs ||
      (group != 2 && n_dl != 1) || R * n_dl > kMaxRows || N < 64 ||
      N % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (shape < 0 || shape > 2 ||
      (shape == 1 && (group != 3 || R != kShapeRows || N % 128 != 0)) ||
      (shape == 2 && (group != 2 || R != kUintRows || n_dl != kUintLimbs ||
                      N % 128 != 0)))
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
    if (shape && live &&
        ((shape == 1 ? row_group[i] != 4 && row_group[i] != 2 : row_group[i] != 2) ||
         primes[i] < kMinPrime || (shape == 2 && primes[i] > kMaxPackedPrime)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shape == 1) {
    static_assert(stages_that_fit(3, kShapeRows, 128, 128) >= 3, "stages");
    return launch<3, 128, 128, kShapeRows>(digits, bsk, ts, f_lo, f_hi, rot, v,
                                           sp, n_primes, B, R, n_dl, N, s);
  }
  if (shape == 2) {
    static_assert(stages_that_fit(2, kUintRows, 128, 128) >= 3, "stages");
    return launch<2, 128, 128, kUintRows>(digits, bsk, ts, f_lo, f_hi, rot, v,
                                          sp, n_primes, B, R, n_dl, N, s);
  }
  return group == 2 ? dispatch<2>(digits, bsk, ts, f_lo, f_hi, rot, v, sp,
                                  n_primes, B, R, n_dl, N, s)
                    : dispatch<3>(digits, bsk, ts, f_lo, f_hi, rot, v, sp,
                                  n_primes, B, R, n_dl, N, s);
}

// r[i] = the shape instances' Barrett of x[i] modulo p, i < n (device
// pointers).
extern "C" int ztfhe_ntt_step_barrett(const int* x, int* r, int n, int p,
                                      float inv_p, void* stream) {
  if (n < 0 || p < kMinPrime) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(4 * sm_count());
  barrett_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      x, r, n, p, inv_p);
  return static_cast<int>(cudaGetLastError());
}

// Adds to *n_diff (device) the count of x = start + i (mod 2^32), 0 <= i <
// count, where the shape instances' Barrett differs from the general
// instance's (__float2int_rn(__fmul_rn(__int2float_rn(x), inv_p))).
extern "C" int ztfhe_ntt_step_barrett_mismatches(int start, long long count,
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
