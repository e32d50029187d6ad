// The fused blind-rotation step core, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel zig_tfhe_tpu/ops/pallas/ntt_step.py:
// ntt_step_fused_pallas (Pallas body `_k_fused`, arithmetic
// `_fwd_pointwise_rotate`), and widens it from multi-bit group 2 to group 3,
// the 128-bit key default.  For one step of the blind rotation and each CRT
// prime p it computes, from the accumulator's int8 gadget digits:
//
//   d_hat = barrett(digits @ fwd_lo + 256 * (digits @ fwd_hi))    forward NTT
//   u_S   = sum over rows r of d_hat[r] * bsk[S, p, r]            per subset S
//   v     = sum over subsets S of prod_{i in S}(psi^{t_i} - 1) * u_S
//
// with the reductions placed exactly where the JAX code of each group
// places them, so v is bit-equal to the JAX package's residues:
//   group 2: the Pallas kernel (one row group for every prime, a final
//            Barrett per pointwise sum, barrett(barrett(d1 u1 + d2 u2) +
//            barrett(d12 u12)));
//   group 3: the XLA step_multi fold (pointwise_extprod(reduce_output=
//            False) with per-prime row groups, rotate_combine_multi(u_wide)).
// The forward limb combine is the single add lo + (hi << 8) or, where its
// bound fails (Bg_e = 2^8), barrett(barrett(lo) + 256 barrett(hi)), as
// _limb_pair_combine chooses.
//
// What the TPU kernel did next -- the residue limb split, the concatenated
// inverse NTT -- and what its caller did after it -- crt_combine, << drop,
// acc + -- are K1 (csrc/ntt_inverse.cu).  One step is two launches, this
// kernel then K1, with the residues v [P, B, 2, N] int32 between them in
// device memory (50 MB per step at B = 2048: about 15 us written plus 15 us
// read at 3.35 TB/s).  The split is forced by the data flow: the pointwise
// product and the combine are local to one NTT column k, but the inverse
// contracts over all N columns, so a block that owns a column tile of the
// forward product cannot finish the inverse.
//
// Bound on this card at the path's shapes (B = 2048, N = 1024, P = 3):
//   tensor cores: B * R * N * N * P int8 MACs = 51.5 G at group 3 (R = 4),
//     64.4 G at group 2 (R = 5): 52 us and 65 us at 1,979 TOPS;
//   memory: digits 8-10 MB, key step 0.3-0.4 MB, matrices and psi tables
//     18 MB (L2-resident), v 50 MB out: about 23 us at 3.35 TB/s;
//   CUDA cores: about 48 Barretts per (b, k, prime) at group 3, each an
//     int -> f32 and an f32 -> int conversion; conversions run at a
//     quarter or less of the int32 rate, so this stage, not the tensor
//     cores, is expected to bound the kernel (on the order of 100+ us).
//
// Design (a first, simple version).  One block owns (prime p, a tile of
// TB = 128 / R batch elements with all their R digit rows, a tile of 64 NTT
// columns).  It runs the two forward products with mma.sync m16n8k32 s8
// tiles (the fragment and shared layouts of K1), forms and reduces d_hat
// in the epilogue and stages it [TB * R, 64] int32 in shared memory beside
// the column tile's key residues.  Then each thread owns (b, k) pairs:
// it reads its R d_hat values, gathers the psi rows rot[p][t_j(b) & (2N-1),
// k] itself (on the TPU that gather sat outside in JAX: Mosaic could not
// lower it), runs the pointwise sums and the subset combine in registers,
// and writes v.  Loads are synchronous and single-stage; wgmma, TMA and a
// pipeline are later work.
//
// Exactness.  Barrett is round(f32(x) * f32(1/p)) half to even
// (__float2int_rn(__fmul_rn(__int2float_rn(x), inv_p))), like jnp.round;
// every wrapping sum and product is uint32 (signed overflow is undefined in
// C++); the build passes -fmad=false.  Since every Barrett sees the same
// int32 as in the plain version, the two are compared for equality.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPrimes = 8;
constexpr int kMaxRows = 10;   // digit rows R = la + lb
constexpr int BM = 128;        // MMA rows per block: TB = BM / R batch elements
constexpr int BN = 64;         // NTT columns per block
constexpr int BK = 64;         // contraction chunk (of N) per stage
constexpr int LDS = BK + 16;   // int8 tile row stride (bytes): conflict-free
                               // fragment loads, as in K1
constexpr int LDD = BN + 8;    // d_hat row stride (words): the int2 epilogue
                               // stores of a half-warp hit 32 distinct banks
constexpr int kThreads = 256;  // 8 warps: 4 along rows x 2 along columns

struct StepParams {
  int p[kMaxPrimes];
  float inv_p[kMaxPrimes];
  int row_group[kMaxPrimes];   // rows summed before a Barrett
  int single_add[kMaxPrimes];  // forward limb combine: 1 = lo + (hi << 8)
};

__device__ __forceinline__ uint32_t u32(int x) { return static_cast<uint32_t>(x); }

// round(f32(x) * f32(1/p)) half to even, as jnp.round; r = x - q*p wraps
__device__ __forceinline__ int barrett(uint32_t x, int p, float inv_p) {
  const int q = __float2int_rn(__fmul_rn(__int2float_rn(static_cast<int>(x)), inv_p));
  return static_cast<int>(x - u32(q) * u32(p));
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

// The pointwise sums of one (b, k): u[s][c] = sum_r d[r] * key[s, r, c],
// with a Barrett after every `rg` rows.  Group 2 (the Pallas kernel): the
// group partials are summed and reduced once more.  Group 3
// (pointwise_extprod, reduce_output=False): partials beyond two fold
// pairwise from the front, and the last two are added unreduced.  The row
// loop is outermost and not unrolled, so the group-end test runs once per
// row for all 2S sums, and the code holds one copy of the 2S-wide body.
// d[r] is d_col[r * LDD]; key[s, r, c] is k_col[((s * R + r) * 2 + c) * BN].
template <int G>
__device__ __forceinline__ void pointwise(const int* d_col, const int16_t* k_col,
                                          int R, int rg, int p, float inv_p,
                                          int (&u)[(1 << G) - 1][2]) {
  constexpr int S = (1 << G) - 1;
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
    const uint32_t dr = u32(d_col[r * LDD]);
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

// digits: int8 [B, R, N]       gadget digits of the accumulator
// bsk:    int16 [S, P, R, 2, N] one step of the key (S = 2^G - 1 subsets)
// ts:     int32 [G, B]          rotation amounts in [0, 2N]
// f_lo, f_hi: int8 [P, N, N]    forward matrix limbs, transposed (k, j) so
//                               the contraction axis is contiguous
// rot:    int16 [P, 2N, N]      centered psi^{t(2k+1)}
// v:      int32 [P, B, 2, N]
template <int G>
__global__ void __launch_bounds__(kThreads)
ntt_step_fused_kernel(const int8_t* __restrict__ digits,
                      const int16_t* __restrict__ bsk,
                      const int* __restrict__ ts,
                      const int8_t* __restrict__ f_lo,
                      const int8_t* __restrict__ f_hi,
                      const int16_t* __restrict__ rot, int* __restrict__ v,
                      StepParams sp, int n_primes, int B, int R, int N) {
  constexpr int S = (1 << G) - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* a_s = reinterpret_cast<int8_t*>(smem);              // [BM][LDS]
  int8_t* b_lo = a_s + BM * LDS;                               // [BN][LDS]
  int8_t* b_hi = b_lo + BN * LDS;                              // [BN][LDS]
  int* d_s = reinterpret_cast<int*>(b_hi + BN * LDS);          // [BM][LDD]
  int16_t* k_s = reinterpret_cast<int16_t*>(d_s + BM * LDD);   // [S*R*2][BN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int tb = BM / R;
  const int b0 = blockIdx.y * tb;
  const int nb = min(tb, B - b0);        // live batch elements of the tile
  const int rows = nb * R;               // live MMA rows
  const int col0 = blockIdx.x * BN;
  const int pi = blockIdx.z;
  const int p = sp.p[pi];
  const float inv_p = sp.inv_p[pi];

  // the column tile's key residues: k_s[(s*R + r)*2 + c][k], 16 B loads
  for (int idx = tid; idx < S * R * 2 * (BN / 8); idx += kThreads) {
    const int kr = idx / (BN / 8), c8 = idx % (BN / 8);
    const int s = kr / (2 * R), rc = kr % (2 * R);
    const int16_t* src =
        bsk + (static_cast<size_t>(s * n_primes + pi) * 2 * R + rc) * N +
        col0 + c8 * 8;
    *reinterpret_cast<int4*>(k_s + kr * BN + c8 * 8) =
        *reinterpret_cast<const int4*>(src);
  }

  // -- forward NTT: [rows, N] @ [N, BN], lo and hi matrix limbs -----------
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
  const int8_t* dig = digits + static_cast<size_t>(b0) * R * N;
  const int8_t* flo = f_lo + static_cast<size_t>(pi) * N * N;
  const int8_t* fhi = f_hi + static_cast<size_t>(pi) * N * N;
  for (int k0 = 0; k0 < N; k0 += BK) {
    __syncthreads();  // the previous stage's fragments are consumed
#pragma unroll
    for (int it = 0; it < (BM * BK / 16) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx / (BK / 16), c = idx % (BK / 16);
      int4 x = make_int4(0, 0, 0, 0);
      if (r < rows)
        x = *reinterpret_cast<const int4*>(dig + static_cast<size_t>(r) * N +
                                           k0 + c * 16);
      *reinterpret_cast<int4*>(a_s + r * LDS + c * 16) = x;
    }
    {
      const int r = tid / (BK / 16), c = tid % (BK / 16);
      const size_t o = static_cast<size_t>(col0 + r) * N + k0 + c * 16;
      const int so = r * LDS + c * 16;
      *reinterpret_cast<int4*>(b_lo + so) = *reinterpret_cast<const int4*>(flo + o);
      *reinterpret_cast<int4*>(b_hi + so) = *reinterpret_cast<const int4*>(fhi + o);
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int o = (wm * 32 + mt * 16 + g) * LDS + ks + t * 4;
        a[mt][0] = lds32(a_s + o);
        a[mt][1] = lds32(a_s + o + 8 * LDS);
        a[mt][2] = lds32(a_s + o + 16);
        a[mt][3] = lds32(a_s + o + 8 * LDS + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int o = (wn * 32 + nt * 8 + g) * LDS + ks + t * 4;
        const uint32_t l0 = lds32(b_lo + o), l1 = lds32(b_lo + o + 16);
        const uint32_t h0 = lds32(b_hi + o), h1 = lds32(b_hi + o + 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(zlo[mt][nt], a[mt], l0, l1);
          mma_s8(zhi[mt][nt], a[mt], h0, h1);
        }
      }
    }
  }

  // epilogue: limb combine + Barrett -> d_hat in shared memory
  const bool single = sp.single_add[pi] != 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int lo = zlo[mt][nt][2 * h + j], hi = zhi[mt][nt][2 * h + j];
          y[j] = single
                     ? barrett(u32(lo) + (u32(hi) << 8), p, inv_p)
                     : barrett(u32(barrett(u32(lo), p, inv_p)) +
                                   u32(barrett(u32(hi), p, inv_p)) * 256u,
                               p, inv_p);
        }
        const int r = wm * 32 + mt * 16 + g + 8 * h;
        const int c = wn * 32 + nt * 8 + t * 2;
        *reinterpret_cast<int2*>(d_s + r * LDD + c) = make_int2(y[0], y[1]);
      }
  __syncthreads();

  // -- pointwise external products + subset combine, per (b, k) -----------
  const int k = tid % BN;
  const int rg = sp.row_group[pi];
  const int16_t* rot_k = rot + static_cast<size_t>(pi) * 2 * N * N + col0 + k;
  for (int b = tid / BN; b < nb; b += kThreads / BN) {
    const int gb = b0 + b;
    int u[S][2];
    pointwise<G>(d_s + b * R * LDD + k, k_s + k, R, rg, p, inv_p, u);

    int raw[G];
#pragma unroll
    for (int j = 0; j < G; ++j)
      raw[j] = rot_k[static_cast<size_t>(ts[j * B + gb] & (2 * N - 1)) * N];

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
      for (int j = 0; j < G; ++j) dm[1 << j] = raw[j] - 1;
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
#pragma unroll
    for (int c = 0; c < 2; ++c)
      v[((static_cast<size_t>(pi) * B + gb) * 2 + c) * N + col0 + k] = out[c];
  }
}

size_t smem_bytes(int group, int R) {
  return static_cast<size_t>(BM) * LDS + 2 * BN * LDS + BM * LDD * 4 +
         static_cast<size_t>((1 << group) - 1) * R * 2 * BN * 2;
}

template <int G>
cudaError_t launch(const int8_t* digits, const int16_t* bsk, const int* ts,
                   const int8_t* f_lo, const int8_t* f_hi, const int16_t* rot,
                   int* v, const StepParams& sp, int n_primes, int B, int R,
                   int N, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory needs the cap raised (per device)
  const cudaError_t e = cudaFuncSetAttribute(
      ntt_step_fused_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(G, R)));
  if (e != cudaSuccess) return e;
  const int tb = BM / R;
  const dim3 grid(N / BN, (B + tb - 1) / tb, n_primes);
  ntt_step_fused_kernel<G><<<grid, kThreads, smem_bytes(G, R), stream>>>(
      digits, bsk, ts, f_lo, f_hi, rot, v, sp, n_primes, B, R, N);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch (0 = ok).
// The caller guarantees: device pointers of the stated shapes, contiguous,
// 16-byte aligned; N % 64 == 0; 1 <= n_primes <= 8; 1 <= R <= 10.
extern "C" int ztfhe_ntt_step_fused(
    const int8_t* digits, const int16_t* bsk, const int* ts,
    const int8_t* f_lo, const int8_t* f_hi, const int16_t* rot, int* v,
    const int* primes, const float* inv_p, const int* row_group,
    const int* single_add, int n_primes, int group, int B, int R, int N,
    void* stream) {
  if (n_primes < 1 || n_primes > kMaxPrimes || (group != 2 && group != 3) ||
      B < 1 || R < 1 || R > kMaxRows || N < BN || N % BN != 0 || N % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StepParams sp;
  for (int i = 0; i < kMaxPrimes; ++i) {
    const bool live = i < n_primes;
    sp.p[i] = live ? primes[i] : 1;
    sp.inv_p[i] = live ? inv_p[i] : 1.0f;
    sp.row_group[i] = live ? row_group[i] : 1;
    sp.single_add[i] = live ? single_add[i] : 1;
    if (sp.row_group[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      group == 2 ? launch<2>(digits, bsk, ts, f_lo, f_hi, rot, v, sp, n_primes,
                             B, R, N, s)
                 : launch<3>(digits, bsk, ts, f_lo, f_hi, rot, v, sp, n_primes,
                             B, R, N, s);
  return static_cast<int>(e);
}

extern "C" const char* ztfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
