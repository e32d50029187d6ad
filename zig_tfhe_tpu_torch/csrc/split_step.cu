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
//     (120 pointwise, 10 combine, 5 DP, 30 apply); a Barrett counted as its
//     least work (2 conversions, 1 f32 multiply, 1 int32 multiply-subtract)
//     and the stage at the issue rate of 128 a clock per SM: 21.0 SM-clocks
//     per (b, k) over the 4 primes x 2.1 M (b, k) / 132 SMs / 1.98 GHz =
//     168.8 us;
//   memory: digits 21 MB, key step 1 MB, matrices 8.4 MB, the psi rows
//     gathered (at most the whole table, 16.8 MB), limb planes out 67 MB:
//     about 34 us at 3.35 TB/s.
// So the tensor cores bound it, the CUDA-core stage close behind
// (chip_smoke.py:_k2s_bound_ms computes both from the run's shapes).
// L2 -> SM traffic of this tiling: every (prime, column tile) reads the
// digits (4 x 8 x 21 MB = 0.7 GB) and every row tile of 6 lanes all four
// primes' matrices (342 x 8.4 MB = 2.9 GB): 3.6 GB a call, about 2.7x K2's
// at g2; the tile is one wgmma tall, as K2's.
//
// Design: K2's, the one-limb group-2 case, with a split-shaped epilogue.
// Persistent blocks, one per SM, walk the tiles (prime, column tile, row
// tile; row tiles fastest).  A tile is 64 wgmma rows (TB = 64 / 2R lanes
// with all their half-rows: 6 at 2R = 10, rows 60-63 computed and unused) x
// BN columns (BN = 128; 32 when 128 would leave SMs without a tile).  Five
// warpgroups:
//   * a producer warp: one thread fills a ring of stages with TMA (BK = 128
//     contraction bytes of the digit tile and of both matrix tiles,
//     128-byte swizzle), `full` mbarriers carrying the byte count;
//   * one product warpgroup: per stage 8 wgmma.m64nBNk32.s8.s8 (4
//     contraction steps x 2 matrix limbs), the stage released when its
//     group has retired; after the last stage the reduce-then-combine
//     Barretts of every sum, stored as int16 d_hat (|d_hat| <= 0.52 p <
//     2^15) into one of two shared buffers (`d_full` / `d_empty`);
//   * three pointwise warpgroups, thread = column k: they stage the column
//     tile's key residues (3 subsets x 2R rows x 4 planes x BN int16, 30 KB
//     at BN = 128) and the tile's rotations, wait for d_hat, gather the
//     rot rows of u_j = t_j >> 1 two lanes ahead, build the subset pairs,
//     and run one subset at a time (its 4 pointwise sums, then its share
//     of the apply), so that only 4 + 4 sums are live, then write the 8
//     int8 limb bytes of (b, k).
// The int16 d_hat buffers leave room for 3 ring stages beside two
// buffers at BN = 128.
//
// Exactness.  Barrett is round(f32(x) * f32(1/p)) half to even
// (__float2int_rn(__fmul_rn(__int2float_rn(x), inv_p))), like torch.round;
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
constexpr int BM = 64;          // wgmma rows per tile: TB = BM / 2R
constexpr int BK = 128;         // contraction bytes per stage
constexpr int kPointwiseGroups = 3;
constexpr int kPointwiseThreads = 128 * kPointwiseGroups;
constexpr int kThreads = 128 * (kPointwiseGroups + 2);
// registers a thread: the launch gives every thread kBaseRegs; the producer
// keeps 24 and the product warpgroup takes what that frees
constexpr int kBaseRegs = 65536 / kThreads / 8 * 8;
constexpr int kProductRegs = 2 * kBaseRegs - 24 > 232 ? 232 : 2 * kBaseRegs - 24;
constexpr int kBuffers = 2;     // d_hat buffers between product and pointwise
constexpr int kMaxStages = 8;
constexpr int kSmemCap = 232448;   // bytes a block can use on this card
// full[kMaxStages], empty[kMaxStages], d_full[kBuffers], d_empty[kBuffers]
constexpr int kBarrierBytes = (2 * kMaxStages + 2 * kBuffers) * 8;

struct StepParams {
  int p[kMaxPrimes];
  float inv_p[kMaxPrimes];
};

__device__ __forceinline__ uint32_t u32(int x) { return static_cast<uint32_t>(x); }

// round(f32(x) * f32(1/p)) half to even, as torch.round; r = x - q*p wraps
__device__ __forceinline__ int barrett(uint32_t x, int p, float inv_p) {
  const int q = __float2int_rn(__fmul_rn(__int2float_rn(static_cast<int>(x)), inv_p));
  return static_cast<int>(x - u32(q) * u32(p));
}

// The 4 pointwise sums of one (b, k) and one subset: u[c'] = sum_r d[r] *
// key[r, c'], a Barrett after every `rg` rows, the group partials summed and
// reduced once more (ops/split_ring.py:_pointwise).  d[r] is d_col[r * LDD],
// key[r, c'] is k_col[(r * 4 + c') * BN].
template <int BN, int LDD>
__device__ __forceinline__ void pointwise(const int16_t* d_col,
                                          const int16_t* k_col, int RL, int rg,
                                          int p, float inv_p,
                                          int (&u)[kPlanes]) {
  uint32_t part[kPlanes], acc[kPlanes];
#pragma unroll
  for (int c = 0; c < kPlanes; ++c) {
    part[c] = 0u;
    acc[c] = 0u;
  }
  int cnt = 0;
#pragma unroll 1
  for (int r = 0; r < RL; ++r) {
    const uint32_t dr = u32(static_cast<int>(d_col[r * LDD]));
#pragma unroll
    for (int c = 0; c < kPlanes; ++c)
      part[c] += dr * u32(static_cast<int>(k_col[(r * kPlanes + c) * BN]));
    if (++cnt == rg || r == RL - 1) {
      cnt = 0;
#pragma unroll
      for (int c = 0; c < kPlanes; ++c) {
        acc[c] += u32(barrett(part[c], p, inv_p));
        part[c] = 0u;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kPlanes; ++c) u[c] = barrett(acc[c], p, inv_p);
}

// shared memory of one block: the ring, then two buffers of d_hat [BM][BN +
// 8] int16, the key tile [3 * 2R * 4][BN] int16 and the tile's rotation
// amounts [2][TB] int32, then the barriers
__host__ __device__ constexpr int stage_bytes(int bn) {
  return BM * BK + 2 * bn * BK;
}
__host__ __device__ constexpr int dhat_bytes(int bn) {
  return BM * (bn + 8) * 2;
}
__host__ __device__ constexpr int key_tile_bytes(int RL, int bn) {
  return kSubsets * RL * kPlanes * bn * 2;
}
__host__ __device__ constexpr int buffer_bytes(int RL, int bn) {
  return dhat_bytes(bn) + key_tile_bytes(RL, bn) + BM * 2 * 4;
}
// stages that fit beside the two buffers (at most kMaxStages)
__host__ __device__ constexpr int stages_that_fit(int RL, int bn) {
  const int left = kSmemCap - 1024 - kBuffers * buffer_bytes(RL, bn) -
                   kBarrierBytes;
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
// (N is the transform size, half the ring degree.)
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
split_step_kernel(const __grid_constant__ CUtensorMap map_d,
                  const __grid_constant__ CUtensorMap map_lo,
                  const __grid_constant__ CUtensorMap map_hi,
                  const int16_t* __restrict__ bsk, const int* __restrict__ ts,
                  const int16_t* __restrict__ rot, int8_t* __restrict__ v,
                  StepParams sp, int n_primes, int rg, int B, int RL, int N,
                  int n_stages) {
  constexpr int REGS = BN / 2;     // sums per thread of a 64 x BN tile
  constexpr int LDD = BN + 8;      // d_hat row stride (int16): the 32-bit
                                   // stores of a warp hit 32 distinct banks
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tiles = align_1024(smem);
  unsigned char* bufs = tiles + n_stages * stage_bytes(BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      bufs + kBuffers * buffer_bytes(RL, BN));
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
      for (int id = blockIdx.x; id < n_tiles; id += gridDim.x) {
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
      for (int kc = 0; kc < nk; ++kc) {
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
      if (elected) mbar_arrive(empty + pending);

      // reduce-then-combine + Barrett -> int16 d_hat, in the buffer the
      // pointwise warpgroups have finished with (its first use is free)
      const int buf = j % kBuffers;
      int16_t* d_s = reinterpret_cast<int16_t*>(bufs + buf * buffer_bytes(RL, BN));
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
      unsigned char* base = bufs + buf * buffer_bytes(RL, BN);
      const int16_t* d_s = reinterpret_cast<const int16_t*>(base);
      int16_t* k_s = reinterpret_cast<int16_t*>(base + dhat_bytes(BN));
      int* ts_s = reinterpret_cast<int*>(base + dhat_bytes(BN) +
                                         key_tile_bytes(RL, BN));

      // the column tile's key residues: k_s[(m*2R + r)*4 + c'][k], 16 B
      // loads.  (Every thread is past its reads of this buffer's tile j - 2:
      // it has passed the barrier below in tile j - 1.)
      const int key_rows = kSubsets * RL * kPlanes;
      for (int idx = pt; idx < key_rows * (BN / 8); idx += kPointwiseThreads) {
        const int kr = idx / (BN / 8), c8 = idx % (BN / 8);
        const int m = kr / (RL * kPlanes), rc = kr % (RL * kPlanes);
        const int16_t* src =
            bsk + (static_cast<size_t>(m * n_primes + pi) * RL * kPlanes + rc) * N +
            col0 + c8 * 8;
        *reinterpret_cast<int4*>(k_s + kr * BN + c8 * 8) =
            *reinterpret_cast<const int4*>(src);
      }
      // the tile's rotations: ts_s[jj * tb + b] = t_jj(b0 + b) mod 4N
      for (int idx = pt; idx < 2 * nb; idx += kPointwiseThreads) {
        const int jj = idx / nb, b = idx % nb;
        ts_s[jj * tb + b] = ts[jj * B + b0 + b] & (4 * N - 1);
      }
      named_barrier_sync(1, kPointwiseThreads);   // key tile, rotations written
      mbar_wait(d_full + buf, (j / kBuffers) & 1);

      const int16_t* rot_k = rot + static_cast<size_t>(pi) * 2 * N * N + col0 + k;
      const int psi1 = rot_k[N];
      // the rows rot[p][u_j(b), k] are gathered two batch elements ahead,
      // so that their latency hides behind two elements' arithmetic
      auto gather = [&](int b, int (&r)[2]) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          r[jj] = b < nb ? rot_k[static_cast<size_t>(ts_s[jj * tb + b] >> 1) * N] : 1;
      };
      int raw1[2], raw2[2];
      gather(pt / BN, raw1);
      gather(pt / BN + BSTEP, raw2);
      for (int b = pt / BN; b < nb; b += BSTEP) {
        const int gb = b0 + b;
        int raw[2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          raw[jj] = raw1[jj];
          raw1[jj] = raw2[jj];
        }
        gather(b + 2 * BSTEP, raw2);

        // X^{t_j} - 1 as split pairs (x, y), then the pair of subset {1, 2}
        int x[kSubsets], y[kSubsets];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const bool odd = (ts_s[jj * tb + b] & 1) != 0;
          x[jj] = odd ? -1 : raw[jj] - 1;
          y[jj] = odd ? raw[jj] : 0;
        }
        {
          const int w = barrett(u32(y[1]) * u32(y[0]), p, inv_p);
          x[2] = barrett(u32(x[1]) * u32(x[0]) + u32(psi1) * u32(w), p, inv_p);
          y[2] = barrett(u32(x[1]) * u32(y[0]) + u32(y[1]) * u32(x[0]), p, inv_p);
        }
        uint32_t ve[2] = {0u, 0u}, vo[2] = {0u, 0u};
#pragma unroll 1
        for (int m = 0; m < kSubsets; ++m) {
          int u[kPlanes];
          pointwise<BN, LDD>(d_s + b * RL * LDD + k,
                             k_s + m * RL * kPlanes * BN + k, RL, rg, p, inv_p,
                             u);
          const int xm = m == 0 ? x[0] : m == 1 ? x[1] : x[2];
          const int ym = m == 0 ? y[0] : m == 1 ? y[1] : y[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int ue = u[2 * c], uo = u[2 * c + 1];
            const int we = barrett(u32(ym) * u32(uo), p, inv_p);
            ve[c] += u32(barrett(u32(xm) * u32(ue) + u32(psi1) * u32(we), p, inv_p));
            vo[c] += u32(barrett(u32(xm) * u32(uo) + u32(ym) * u32(ue), p, inv_p));
          }
        }
        // v == lo + 256 hi with lo in [-128, 128): K1's int8 limb planes
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int out = barrett(q ? vo[c] : ve[c], p, inv_p);
            const int lo = ((out + 128) & 255) - 128;
            int8_t* dst =
                v + (((static_cast<size_t>(pi) * B + gb) * 2 + c) * 2 + q) * 2 * N +
                col0 + k;
            dst[0] = static_cast<int8_t>(lo);
            dst[N] = static_cast<int8_t>((out - lo) >> 8);
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

template <int BN>
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
  const int bytes = 1024 + n_stages * stage_bytes(BN) +
                    kBuffers * buffer_bytes(RL, BN) + kBarrierBytes;
  // above 48 KB, dynamic shared memory needs the cap raised (set once per
  // device and size: the call costs host time on a host-bound path)
  thread_local int cap_device = -1, cap_bytes = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device != cap_device || bytes != cap_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_step_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap_device = device;
    cap_bytes = bytes;
  }
  const int tb = BM / RL;
  const int n_tiles = n_primes * (N / BN) * ((B + tb - 1) / tb);
  const dim3 grid(n_tiles < sm_count() ? n_tiles : sm_count());
  split_step_kernel<BN><<<grid, kThreads, bytes, stream>>>(
      map_d, m.map_lo, m.map_hi, bsk, ts, rot, v, sp, n_primes, rg, B, RL, N,
      n_stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
// The 64 x 128 tile when that many tiles give every SM one and 3 stages
// fit beside the consumers' buffers, else 64 x 32.  The caller guarantees:
// device pointers of the stated shapes, contiguous, 16-byte aligned; N %
// 128 == 0; 1 <= n_primes <= 8; 1 <= RL <= 10 half-rows a batch element;
// row_group >= 1.
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
    sp.p[i] = live ? primes[i] : 1;
    sp.inv_p[i] = live ? inv_p[i] : 1.0f;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tb = BM / RL;
  const int row_tiles = (B + tb - 1) / tb;
  if (n_primes * (N / 128) * row_tiles >= sm_count() &&
      stages_that_fit(RL, 128) >= 3)
    return launch<128>(digits, bsk, ts, f_lo, f_hi, rot, v, sp, n_primes,
                       row_group, B, RL, N, s);
  return launch<32>(digits, bsk, ts, f_lo, f_hi, rot, v, sp, n_primes,
                    row_group, B, RL, N, s);
}

extern "C" const char* ztfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
