// Throughput, per SM clock, of the CUDA-core instructions a Barrett
// reduction round(f32(x) * f32(1/p)) is made of on this card, for
// tools/torch_kernel_probe.py --split: int32 -> f32 (__int2float_rn),
// f32 -> int32 (__float2int_rn), int32 multiply-add, and whole Barretts in
// three forms -- both conversions; the rounding as an f32 add of 1.5 * 2^23
// (no f32 -> int conversion); and that with the int32 -> f32 side built
// exactly from two 16-bit halves (no conversion at all).
//
// One block of 1024 threads per SM (the launch asks for more shared memory
// than two blocks could share), each thread 8 independent dependency
// chains of the operation; every block times its loop with clock64(), so
// a rate is results per clock of one SM.  Built with the kernels' flags
// (ops/cuda/_build.py: sm_90a, -fmad=false).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kChains = 8;
constexpr int kSmemBytes = 160 * 1024;   // one block per SM

__device__ __forceinline__ uint32_t u32(int x) { return static_cast<uint32_t>(x); }

// f32(x) rounded to nearest even, exactly, from the two 16-bit halves:
// each half is exact as 2^23 + m - 2^23, the high one scaled by 2^16
// (exact), the sum rounded once
__device__ __forceinline__ float i2f_halves(uint32_t x) {
  const float hi = __fsub_rn(__uint_as_float(0x4B000000u | ((x >> 16) ^ 0x8000u)),
                             8421376.0f);   // 2^23 + 2^15: the bias of the signed half
  const float lo = __fsub_rn(__uint_as_float(0x4B000000u | (x & 0xFFFFu)),
                             8388608.0f);
  return __fadd_rn(__fmul_rn(hi, 65536.0f), lo);
}

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t v, int p, float inv_p) {
  if (OP == 0) return __float_as_uint(__int2float_rn(static_cast<int>(v)));
  if (OP == 1) return u32(__float2int_rn(__uint_as_float(v)));
  if (OP == 2) return v * u32(p) + 12345u;
  if (OP == 3) {   // both conversions
    const int q = __float2int_rn(__fmul_rn(__int2float_rn(static_cast<int>(v)), inv_p));
    return v - u32(q) * u32(p);
  }
  const float f = OP == 4 ? __int2float_rn(static_cast<int>(v)) : i2f_halves(v);
  // round half to even by the add of 1.5 * 2^23 (|f * inv_p| < 2^22)
  const float r = __fadd_rn(__fmul_rn(f, inv_p), 12582912.0f);
  return v - (__float_as_uint(r) - 0x4B400000u) * u32(p);
}

template <int OP>
__global__ void __launch_bounds__(kThreads, 1)
rate_kernel(uint32_t* out, long long* cycles, int iters, int p, float inv_p) {
  uint32_t v[kChains];
#pragma unroll
  for (int i = 0; i < kChains; ++i) v[i] = threadIdx.x * 977u + i * 7919u + blockIdx.x;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) v[i] = step<OP>(v[i], p, inv_p);
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) acc ^= v[i];
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int OP>
int launch(uint32_t* out, long long* cycles, int blocks, int iters, int p,
           float inv_p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      rate_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  rate_kernel<OP><<<blocks, kThreads, kSmemBytes, stream>>>(out, cycles, iters,
                                                           p, inv_p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// op: 0 int32 -> f32, 1 f32 -> int32, 2 int32 multiply-add, 3 Barrett with
// both conversions, 4 Barrett rounding by the f32 add, 5 Barrett with no
// conversion.  out: uint32 [blocks * 1024]; cycles: int64 [blocks], each
// block's clocks over its loop of iters x 8 results a thread.
extern "C" int ztfhe_cvt_rate(int op, uint32_t* out, long long* cycles,
                              int blocks, int iters, int p, float inv_p,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0: return launch<0>(out, cycles, blocks, iters, p, inv_p, s);
    case 1: return launch<1>(out, cycles, blocks, iters, p, inv_p, s);
    case 2: return launch<2>(out, cycles, blocks, iters, p, inv_p, s);
    case 3: return launch<3>(out, cycles, blocks, iters, p, inv_p, s);
    case 4: return launch<4>(out, cycles, blocks, iters, p, inv_p, s);
    case 5: return launch<5>(out, cycles, blocks, iters, p, inv_p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ztfhe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
